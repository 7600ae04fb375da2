#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA card: the paged
``/generate`` path of the TransformerLM and its decode planes (k-step
ticks, speculative decode, the fixed-slot pool, the KV arena's dtype,
the prefill/decode handoff), the ``/predict`` path of the
char-RNN MultiLayerNetwork, the char-RNN's training with truncated BPTT
and RMSProp, Word2Vec skip-gram training with hierarchical softmax
and negative sampling, the TransformerLM's long-context ``ring_forward``
and its sequence-parallel training (ring and Ulysses), the training of a
MultiLayerNetwork of masked MultiHeadAttention layers, the
TransformerLM's training and top-k/top-p sampling, the BERT
encoder's MLM pretraining, fine-tuning and embeddings, and the CNN and
layer-zoo MultiLayerNetworks (LeNet-5's training, AlexNet, VGG16, the DBN
and the stacked autoencoder's pretraining, the Solver, an Embedding-LSTM
net through K1 and K2), the ComputationGraph (ResNet-50 and GoogLeNet
training, a seq2seq graph through K1 and K2, bf16 loss-scaled steps in
both containers), ``/embed`` (an MLP, a ResNet-50 graph record, BERT
through K5, a word2vec table), ``/search`` (exact and IVF indexes over a
1,000,000 x 768 arena, k-means, a StreamSource feed gated by a drift
monitor, BERT passages through K5), the serving path's trace spans,
journal and exporter, and the training runtime (record readers, the
input pipeline and its stager, the native host feed, ResilientTrainer
with async checkpoints and exact resume through K1 and K2, early
stopping), and distributed training (an MoE TransformerLM through K4 and
K7, Megatron and pipeline steps, ParallelWrapper, parameter averaging
through K1 and K2, the sharded checkpoint) on world-1 NCCL groups, and
the serving fleet (a FleetRouter over ServingEngine replicas through K4,
K6 and K1, OS-process replicas, prefill/decode roles, the head-sharded
tick through K6, autoscaling and placement, shadow promotion with the
ContinuousTrainer through K1 and K2, the elastic averaging fleet, and
Word2Vec on a data-parallel group through K3), the NLP, graph and t-SNE
models, and the tooling entry points (the CPU-against-card north-star
harness, the CLI, the training UI and its listeners with a
``torch.profiler`` trace, the host text tools).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

What it does, in order (any failure raises and exits non-zero):

1. prints the card (``nvidia-smi`` name and power limit, and
   ``torch.cuda.get_device_name``); with no CUDA device it exits 2;
2. builds the seven kernels from ``deeplearning4j_tpu_torch/csrc/`` with
   ``nvcc`` (one process per library, started together; K4 and K5 are one
   library over ``csrc/flash_fwd.cuh``; K7, the flash backward, is
   ``csrc/flash_bwd.cu``), prints each function's ptxas
   register and spill line, and checks with ``cuobjdump -sass`` that the
   K4/K5 library holds tensor-core ``HGMMA`` (bf16), TF32 ``HMMA`` (f32:
   3xTF32) and ``cp.async`` ``LDGSTS`` instructions, and that both LSTM
   libraries (K1, K2) hold the cluster barrier (``CLUSTER_BARRIER_SASS``,
   at each cluster's start and end: no grid-wide barrier) and the DSMEM
   stores of the per-step exchange (``STAS``), and K2 TF32 ``HMMA`` (its
   gate and dU products: 3xTF32), and that every K7 kernel holds
   ``LDGSTS`` and, in bf16, ``HGMMA`` (``wgmma``), in f32 TF32 ``HMMA``
   (3xTF32 on ``mma.sync``); then builds the K4/K5 library's variant
   with one bf16 P in P.V (``-DFLASH_P_SPLIT=0``), which is timed and
   read against the shipped split-P kernel and never runs on a path;
3. holds each kernel against its plain PyTorch version on the card at the
   paths' shapes — flash prefill (K4): causal bf16, N=1, H=32, hd=64,
   T in {192, 512, 1024}, max abs error <= 2e-2 on O and <= 1e-3 on lse;
   paged decode (K6): 64 lanes, bt=16, m=64, H=32, hd=64, bf16 arena,
   positions inside block 0, across blocks and at the full window, and
   one lane at the full window among 63 at 16 tokens: max abs error <=
   1e-3, two launches bit-equal, and a trash block poisoned with 1e6 in K
   and -1e6 in V moves no active lane's output by a single bit, and the
   same at the smoke's mix with f32 queries over the bf16 arena (K6's
   ``<float, bf16>`` instantiation, which an f32 model runs under
   ``DL4J_TPU_SERVE_KV_DTYPE=bf16``); LSTM scan (K1), f32,
   with and without the cell sequence, at (N, T, H) = (64, 100, 200) (the
   char-RNN at full width with a full batch), the three shape classes of
   ``benchmarks/pallas_lstm_bench.py`` (32, 128, 128), (64, 256, 256),
   (128, 512, 512), and (1, 8, 200): max abs error <= 1e-4 on hs, h_T,
   c_T and cs, and two launches give the same bits; LSTM scan backward
   (K2), f32, at (N, T, H) = (32, 50, 200)
   (the char-RNN's training window), (64, 100, 200), the three shape
   classes and (1, 8, 200): max error <= 1e-4 on dxproj, dh0 and dc0
   (abs) and on dU and dp (relative to the largest entry: they sum N*T
   products), and two launches give the same bits; the SGNS step (K3),
   f32, at (V, D, B, K+1) = (71290, 128, 2048, 6) (the smoke's word2vec),
   (100000, 100, 1024, 6) (the hot class of ``bench.py:764``), (64, 128,
   2048, 6) (~190 hits per row), with dots pushed past +-MAX_EXP and with
   dead negatives and pairs, against the plain step run in f64 on the
   same inputs (its f32 run on the card adds with atomics onto the
   tables and drifts past the bar itself): max error <= 1e-5 of the
   largest entry of each table's update, two launches bit-equal (each
   row's hits summed in batch order, no float atomics), and every row no
   live pair touches bit-equal;
   K5, flash attention with a key bias and a visibility offset, at (a)
   the ring-local shape of ``bench.py:522`` (N=1, T=4096, H=8, D=64,
   bf16, offset 0), (b) the masked shape of ``bench.py:581`` (N=4,
   T=2048, H=8, D=64, bf16, causal, a seeded key mask keeping ~80 %),
   (c) T=1024 at offsets 1024, 512, -512 and -1024 (the last: O exactly
   0, lse exactly -inf), (d) ragged Tq=192 x Tk=320, (e) a batch row
   with every key masked, (f) f32 at D in {32, 64, 128}, and at the
   shapes the main path gives it: (g) one ring step of the bench
   transformer (N=1, T=4096, H=32, D=64, bf16, offset 0) and (h) a
   layer of the masked MHA fit (N=32, T=512, H=8, D=64, f32, the fit's
   length mask, offset 512): bf16 within 2e-2 on O and 1e-3 on lse,
   f32 within 1e-4 on both, rows with no visible key exactly O = 0 and
   lse = -inf. At (a) and (g), which are K4's function too (g is K4's
   shape in Ulysses and ``forward``), K4 within the same bars of its
   plain version and bit-equal to K5; the one-P variant's and
   ``scaled_dot_product_attention``'s errors against the same plain
   version are printed beside them. And a 4-shard ring driven in one process
   (``ring_flash_step`` for every (my, src) step of a 4-rank ring)
   against the plain full attention, causal and not, with and without a
   key mask, within 2e-2; and K7, the flash backward, against its plain
   version ``flash_block_bwd`` on the same card inputs (o and lse of K5's
   plain forward, seeded cotangents): at the LM's training layer (N=16,
   T=1024, H=32, D=64, bf16, causal), the MHA fit's layer (case h, f32),
   K5's masked case b with an lse cotangent, T=1024 at offset -512 (rows
   with no visible key) with an lse cotangent, a batch row with every key
   masked (its gradients exactly 0), and ragged Tq=300 x Tk=420 at D in
   {16, 32, 128}: within 1e-2 of the largest entry of each gradient in
   bf16 and 1e-4 in f32, two launches bit-equal, masked keys' dK and dV
   exactly 0;
4. serves the full-width transformer the repo benchmarks (d_model 2048,
   4 layers, 32 heads, d_ff 8192, vocab 8192, max_len 1024, bf16, flash
   on; random weights from ``--seed``) through ``ServingEngine``: 16 HTTP
   ``POST /generate`` requests from 8 client threads plus one streamed
   request, prompts of 64-900 tokens, 32-64 new tokens, greedy and
   temperature 0.8, after a warm-up request per prefill width. It checks
   every answer, stream == non-stream, solo == co-scheduled, and that both
   kernels' launch counters rose from 0 during the burst and checks while
   both plain versions' counters stayed at 0;
   then the decode planes on the same model, 64 lanes and 16-token
   blocks, against that burst's answers (``phase_decode_planes``): (a)
   the burst again under ``DL4J_TPU_SERVE_TICK_K=4``, every answer
   byte-equal, ticks, tokens a tick, host wall a tick and tokens/s beside
   k = 1's; (b) the 8 greedy requests under ``DL4J_TPU_SERVE_SPEC=int8``
   and ``=layers:2`` (``SPEC_K`` 4), every transcript byte-equal, K6
   launched exactly layers x ((k+1) x rounds + base ticks) times, a
   ``SpecChaos`` all-reject run (int8) byte-equal, a sampled lane
   holding the pool to the base tick (no round while it is active),
   rounds, proposals, acceptance (random weights: a check of the
   mechanism), tokens a dispatch, wall per committed token, and the
   draft's and the verify's device time at 64 lanes; (c) the fixed-slot
   pool (``kv_block=0``, 4 slots) serving the 16 requests, solo ==
   co-scheduled, K4 launched and no plain version, tokens/s and how far
   its greedy transcripts agree with the paged pool's; (d) an f32 copy
   of the model (the same master tensors) over a bf16 arena and an f32
   one, each sized by ``kv_arena_blocks`` on one 4 GiB budget: ~2x the
   blocks, K6 ``<float, bf16>`` launched, the transcripts' agreement;
   (e) a prefill-role and a decode-role engine (2048 blocks each):
   ``/prefill``, ``/prime``, ``/generate`` for the shortest and longest
   greedy prompt, the answer byte-equal to the unprimed burst's, prefix
   hits equal to the blocks adopted, payload bytes and each leg's wall;
5. serves the full-width char-RNN (``char_rnn_conf(80, lstm_size=200,
   num_layers=2)``, the shape ``bench.py:206`` benchmarks; random weights
   from ``--seed`` through the port's own init) through ``ServingEngine``:
   warms the bucket ladder, sends 64 HTTP ``POST /predict`` requests of
   1-4 one-hot rows of T=100 from 8 client threads, checks every answer
   (HTTP 200, finite probabilities that sum to 1, within 1e-5 of
   ``net.output`` on the same rows alone), that K1's launch counter rose
   during the burst while its plain version's stayed at 0 (and records
   the batch rows N of every K1 launch the batcher made), and samples
   200 characters with ``CharRnn.sample`` through ``rnn_time_step``;
   then the serving planes (``phase_serving_planes``): probes
   ``torch._int_mm``'s shape rules and times the int8 product
   (``ops/lowprec.int8_matmul``) at the char-RNN head's and the lowprec
   bench MLP's shapes beside the f32 ``torch.matmul`` (TF32 off) and the
   bound (1979 TOP/s int8); on an engine built with no model, (a) the
   char-RNN and the lowprec bench's MLP (``bench.py:2876-2891``:
   256-512-512-10, 4 Adam fits on the card) calibrated with
   ``QuantCalibrator``, zipped with ``quant.json`` and loaded through
   ``POST /models`` as an f32 record (``DL4J_TPU_QUANT=0``) and an int8
   one: the gate verdict ``ok`` with its delta, the same 64-request burst
   through each in turns (rows/s), K1 launched and its plain version
   never, the int8 products counted, every int8 answer within 1e-5 of
   ``QuantizedNet.output`` of the rows alone and within the gate's max
   delta of the f32 answer; (b) the resilience bench's MLP
   (``bench.py:1431-1437``) and the char-RNN zipped with a fitted
   ``NormalizerStandardize``: answers within 1e-5 of
   ``output(normalizer.transform(rows))``, K1 launched, ``record_base64``
   == ``record`` bit for bit; (c) a load under
   ``DL4J_TPU_QUANT_MAX_DELTA=1e-9`` (``QuantGateError``), a load and a
   warmup that ``ServingChaos`` fails all land broken while the default
   answers, with the lineage at ``/models``; (d) on the resilience MLP,
   three injected failures open the breaker (503, Retry-After), the
   half-open probe closes it, an injected hang is answered 503 "Wedged"
   by the 2 s watchdog, which trips the breaker, and a fresh worker
   answers after the cooldown (the time to recover) while the hung
   call's late return changes nothing; the burst's greedy requests with
   the third decode admission faulted: that lane alone evicted, the rest
   byte-equal to the burst, K4 and K6 launched and no plain version; (e)
   the bench transformer's zip loaded, warmed and served as lm v1 and v2
   through ``POST /models``, ``/generate`` on v2 and on v1 by version
   equal to the burst (K4, K6 counted), v1 unloaded with
   ``torch.cuda.memory_allocated`` falling by at least its
   ``hbm_report`` ``param_bytes``, a drain with a stream in flight (the
   stream completes, new requests 503 with Retry-After,
   ``/health?ready=1`` live but not ready) and a Prometheus scrape equal
   to the JSON ``/metrics`` on every serving sample; each leg's wall
   time printed;
6. trains the full-width char-RNN (``char_rnn_conf(80, lstm_size=200,
   num_layers=2, tbptt_length=50)``, RMSProp: the shape ``bench.py:206``
   benchmarks and DL4J's ``GravesLSTMCharModellingExample``, at lr 0.003
   where those train at 0.1, see ``TRAIN_LR``; random weights from
   ``--seed``)
   through ``CharRnn.fit_text`` on a synthetic text drawn from a fixed
   random Markov chain over the 80 characters: 30 ``fit`` calls of batch
   32 x T=100 (two TBPTT windows each). It checks that every window's loss
   is finite and the mean of the last 5 fits' losses is below the first,
   that K1 and K2 each launched exactly 4 times per fit (2 windows x 2
   layers) while both plain versions stayed at 0, that one window's
   gradients through the kernels are within 1e-4 (relative to each
   gradient's largest entry) of autograd through the plain forward on
   the same weights, and that ``write_model`` then
   ``MultiLayerNetwork.load`` gives the trained net's ``output``;
7. times each kernel, its plain version and PyTorch's library call where
   one computes the same function (K4: ``scaled_dot_product_attention``)
   with CUDA events (K1, K2, K4, K5, K6 and the library call: the calls
   queued behind a sleep kernel, so the events time the device alone;
   their back-to-back time, host launches included, beside it; K6 also
   at one lane of 1024 tokens among 63 of 16, with GB/s and the bound's
   share)
   beside the bound (max of bytes / 3.35 TB/s and flops /
   peak, H100 SXM data sheet: 989 TFLOP/s dense bf16 for K4 and K6,
   165 TFLOP/s for K1 and K2, the 3xTF32 rate of f32-accurate products,
   67 TFLOP/s f32 for K3), and the
   main paths: prefill ms per width, decode-tick ms at 64 lanes,
   generated tokens/s, ``output()`` ms at batch 64, ``/predict`` rows/s,
   ``fit`` ms and training characters/s, peak device memory. For K1 and
   K2 it also prints the sequential floor (T steps, each at the per-step
   time of a one-row launch: one cluster) and, for K1, as a reference
   line only, cuDNN's ``torch.nn.LSTM`` at the same shape (no peepholes:
   not the same function); K1 is also timed with the cell sequence at
   the training window;
8. trains word2vec (``Word2Vec(layer_size=128, window=5, negative=5,
   batch_size=2048, epochs=1, min_word_frequency=5)``, the model of
   ``bench.py:3433``) with ``fit_tokens`` on a seeded synthetic corpus of
   1.0 M tokens over 71,290 words planted in 100 topics (``topic_corpus``;
   every word occurs at least 5 times, so the vocabulary is exactly the
   71,290 words of text8 at min count 5). It checks that the tables are
   finite, that K3 launched once per negative-sampling batch and its
   plain version never, that the topic agreement of the 10 nearest
   neighbours of the 1,000 most frequent words is at least 10x chance and
   no more than 0.05 below the CPU rehearsal's (``W2V_AGREEMENT_CPU``),
   that the negative-sampling margin (``ns_margin``: how far syn1neg,
   which only K3 writes, scores the pairs above the negatives) is at
   least half the rehearsal's (``W2V_NS_MARGIN_CPU``), that ``save_word2vec`` then ``load_word2vec`` gives bit-equal tables,
   that the fit's skip-gram chunks ran as CUDA graph replays, and that
   16 batches through K3 agree with the same batches through the
   plain step (same draws; f64, rounded once per batch; the HS ops
   deterministic in both runs) within 1e-5 of the largest update, and
   the same 16 batches replayed as one graph with the eager loop (bit-
   equal where the graph captures under ``use_deterministic_algorithms``,
   else within 1e-5 of each table's change). It times the host's
   vocabulary, Huffman and pair assembly, the device loop (skip-gram
   pairs/s, ``bench.py:3445``'s metric, with the graphs' captures and
   without), K3 at both shapes, at V=64 and at B=1 (its floor) beside its
   plain version and bound (device time behind a sleep kernel, back to
   back, and each launch from ``torch.profiler``), breaks 16 batches
   down, eager and replayed, with ``torch.profiler`` (K3, the draws, the
   HS and glue ops, the host gaps; K3's two kernels once per batch in the
   trace and on the counter) and reports the phase's peak device memory;
9. joins a world-1 NCCL group (``parallel/mesh.init_seq_group``) and
   runs ``ring_forward`` on the bench transformer (as in 4, at max_len
   4096) at N=1, T=4096, bf16: finite logits within 5e-2 of ``forward``
   (K4) on the same tokens (and says whether they are bit-equal), and
   within 1e-3 in f32 at T=1024; K5 launched once per layer (4), its plain
   version and K4 never; ``strategy="ulysses"`` within 5e-2 of
   ``forward`` with K4 launched once per layer (its local attention over
   all T); times both forwards and breaks the ring's down with
   ``torch.profiler`` (K5, GEMMs, other kernels, host gaps). On the same
   group it trains the bench transformer at max_len 4096 in the sequence
   mode (``TransformerLM(cfg, group=...)``, Adam lr 1e-4): 3 ``fit``
   steps and one ``fit_batches`` of 3 on a global batch of 4 x T=4096 of
   the Markov stream (see 12), then 3 steps of ``make_ring_train_step(...,
   strategy="ulysses")``. Checks: finite losses that fall; per layer per
   step K5 and K7 once (ring), K4 and K7 once (Ulysses), no plain
   version; nonzero gradients in Wq, Wk and Wv; from the same weights
   and batch, the first ring step's loss (1e-2 relative), gradients and
   updated leaves (1e-2 of each leaf's largest entry for Wq, Wk, Wv, Wo,
   2e-2 for the rest: the card LM step test's bars) against the dense
   ``make_train_step``'s. Then K7 under a real lse cotangent: the
   4-shard ring driven in one process forward and backward
   (``ring_flash_step`` for every (my, src), with autograd) at the LM's
   layer (N=4, T=4096, H=32, D=64, bf16 causal) and at K5's masked case
   b: dq, dk, dv within 1e-2 of each gradient's largest entry of the same
   chain through the plain versions and of the dense backward, masked
   keys' dK and dV exactly 0, K5 and K7 once per step and a nonzero lse
   cotangent into every K7 call. Prints each strategy's step ms, tokens/s
   and profile (K4 or K5, K7, GEMMs, Adam, other, NCCL, host gaps) and
   the phase's peak memory;
10. trains a MultiLayerNetwork of two ``MultiHeadAttention(n_out=512,
   num_heads=8)`` layers and an ``RnnOutputLayer`` in f32 with Adam: 20
   ``fit`` calls of N=32 x T=512 seeded sequences of lengths 64-512 with
   a feature mask. Checks: finite losses, the mean of the last 5 below
   the first, K5 launched twice per fit and nothing else of attention,
   one fit's gradients within 1e-4 of the largest entry of autograd
   through K5's plain version, ``write_model`` then ``load`` gives the
   same ``score``; times and profiles a ``fit``. Then times K5 at cases
   a, b and g (bf16; the one-P variant too at a and g) and h (f32, the
   fit's layer) beside its plain version, ``scaled_dot_product_attention``
   with the equivalent causal or boolean mask (TF32 off), and its bound
   (bytes, and 4·D flops per visible pair at 989 TFLOP/s for bf16 and at
   the 3xTF32 rate, 165 TFLOP/s, for f32);
11. times K7 at the LM's training layer (bf16) and at case h (f32) beside
   its plain version, the backward of ``scaled_dot_product_attention`` on
   the same inputs (device time), its bound (bytes, and 10·D flops of
   five products per visible pair at 989 TFLOP/s bf16 or the 3xTF32
   rate, 165 TFLOP/s, for f32) and the tile pairs it runs;
12. trains the bench transformer (as in 4; ``bench.py:371``
   ``bench_transformer``: Adam at lr 1e-4, f32 masters, bf16 compute) on
   a seeded Markov token stream (4 successors a token): 5 ``fit`` steps
   of 16 x T=1024, then one ``fit_batches`` of 5. Checks: finite losses
   that fall, K4 and K7 launched once per layer per step and their plain
   versions never, nonzero gradients in Wq, Wk and Wv, ``save`` then
   ``TransformerLM.load`` gives bit-equal logits; then ``generate`` with
   top_k 40 and top_p 0.9 (K4 in its prefill), one HTTP ``/generate``
   with top_k answering 200 with ``lm.generate``'s tokens, and a streamed
   one with top_k answering 400. Prints the step's ms, training tokens/s,
   its profile (K4, K7, GEMMs, Adam, other kernels, host gaps) and the
   phase's peak device memory; and one dense step's ms and peak memory
   by default, under ``DL4J_TPU_REMAT=dots``, ``=block`` and under
   ``DL4J_TPU_BF16=1``;
13. trains the BERT encoder at BERT-base widths (google-research/bert
   ``uncased_L-12_H-768_A-12``: vocab 30522, d_model 768, 12 layers, 12
   heads, d_ff 3072, max_len 512; pad 0, [MASK] 103; the repo's pre-LN
   blocks, no segment embeddings, no pooler), strict f32, Adam lr 1e-4,
   on a seeded Markov stream of 16 x T=512 rows with lengths 128-512 and
   pad tails: 5 MLM ``fit`` steps and one ``fit_batches`` of 3. Checks:
   finite losses, and the 8 batches' mean loss under their training
   masks lower after the steps than before; K5 and K7 once per layer per
   step and their plain versions never; nonzero gradients in Wq, Wk and Wv; ``save``
   then ``BertMLM.load`` gives bit-equal ``predict_logits``;
   ``embed_tokens`` finite, with an all-pad row within 1e-4 of the JAX
   package's -1e9 attention (the mean of V); a ``BertClassifier``
   fine-tuned 10 steps on a planted two-class label reaches 0.75 on 64
   held-out rows, and ``encoder_lr_scale=0`` leaves the encoder
   bit-equal. Prints the MLM step's ms, non-pad tokens/s, profile and the
   phase's peak memory, and times K5 and K7 at BERT's layer (N=16,
   T=512, H=12, D=64, f32, the phase's key mask) beside their plain
   versions, ``scaled_dot_product_attention`` with the boolean mask (its
   backward for K7; TF32 off) and their bounds;
14. the CNN and layer-zoo MultiLayerNetworks (``phase_cnn_zoo``), all at
   full width, strict f32 (cuDNN with TF32 off), on the MNIST stand-in
   (``datasets/fetchers._synthetic_mnist``; local idx files where
   ``DL4J_TPU_DATA_DIR`` holds them) and seeded images: (a) LeNet-5
   (``build_lenet5``: Nesterovs 0.01, momentum 0.9, l2 5e-4) at
   ``bench.py``'s protocol, batch 512 over 4 rotating batches: the first
   step against the same step on the CPU (loss and every param leaf
   within 1e-4 of its largest entry), 30 timed ``fit``s after 3 warm-up
   ones,
   then ``fit_batches`` of K=32 three times; samples/s of both, ms per
   step, a profile of one step (conv forward and backward, pooling,
   GEMMs, updater, other, host gaps); the loss must fall; (b) AlexNet at
   227 (``output`` at batch 128, then 5 training steps) and VGG16 at 224
   (3 training steps at batch 32): ms per step, images/s, peak memory and
   a step's profile; at batch 2 the logits on the card within 1e-4 of the
   largest of the CPU's on the same weights; finite losses; (c) the DBN
   (784-500-250-200-10, binary CD-1) and the stacked denoising
   autoencoder (784-500-250-10), each through ``fit_iterator`` over 8
   batches of 128 binarized stand-in digits (layerwise pretraining over
   the 8 batches, then a fine-tuning ``fit`` per batch) and 2 more
   ``fit``s: 10 fine-tune steps; each layer's reconstruction loss on the
   1,024 digits just before and just after its own pretraining (it must
   fall) and the fine-tune losses (they must fall); (d) the LeNet-5
   conf under ``line_gradient_descent``, ``conjugate_gradient`` and
   ``lbfgs``, one ``fit`` of ``iterations=5`` each on a batch of 512:
   the score must fall, ms per iteration; (e) the layer zoo: an
   ``EmbeddingLayer(80 -> 200) -> GravesLSTM(200, tanh) ->
   RnnOutputLayer(80)`` net, 10 ``fit``s at 32 x 100 (K1 and K2 once per
   fit, their plain versions never), and a CNN zoo (conv, BN on NHWC,
   LRN, avg pooling, dense, BN, Activation) and an RNN zoo (GRU, a
   bidirectional LSTM, masked): one ``fit`` and ``output`` each, the card
   within 1e-4 of each layer's (params, states) and the output's largest
   entry of the CPU on the same weights;
15. the ComputationGraph (``phase_graph``), strict f32: (a) ResNet-50 at
   224, 1000 classes (``bench.py:271-330``: batch 128, Nesterovs lr
   0.05): the first step at batch 2 against the CPU on the same weights
   (loss, every vertex's params and BN state within 1e-4 of the vertex's
   largest entry), then 10 steps: ms a step, images/s, the step's FLOPs
   counted from the conf (``graph_train_flops``) and the f32 bound, peak
   memory, a step's profile (convs, BN's reductions and elementwise
   passes with the ReLUs and residual adds, GEMMs, the updater, host
   gaps); (d) under ``DL4J_TPU_BF16=1`` 5 loss-scaled steps of LeNet-5
   at batch 512 and of that ResNet-50 ((scale, good, skipped) after
   each, ms beside the f32 step), then a step made non-finite by an inf
   planted in the first conv's weight: params, states and updater state
   bit-equal to before, the scale halved, one skip counted; (b) GoogLeNet
   with its aux heads at 224, batch 64: ``output`` gives three heads, the
   main first, the score is their three losses plus the l2 penalty, 3
   steps: ms, images/s; (c) the seq2seq graph at the char-RNN's widths
   (GravesLSTM(80 -> 200) encoder, LastTimeStep, DuplicateToTimeSeries
   against the decoder input, Merge, GravesLSTM(280 -> 200) decoder,
   RnnOutputLayer(80)) at 32 x 100: the first fit against the CPU, then
   10 fits (K1 and K2 twice per fit, their plain versions never; the
   loss must fall), one TBPTT-50 fit (K1 and K2 twice a window, the
   decoder's h carried), ``rnn_time_step`` over the sequence against
   ``output``'s last step within 1e-4;
16. ``/embed`` (``phase_embed``) on one engine with no model: the
   retrieval bench's MLP (``bench.py:3041-3048``) zipped and loaded
   through ``POST /models``, 128 single-row calls (p50, p99), the
   batcher against the direct call at 1, 5 and 8 rows within 1e-5,
   ``record`` and ``batch`` over HTTP; ResNet-50 zipped and loaded as a
   graph record (the default vertex, ``avgpool``: 2048 wide) against its
   ``feed_forward`` within 1e-5, and ``/predict`` of it (the first
   output); BERT-base zipped and loaded, token rows through K5 pooled by
   mean (HTTP), cls and max (the engine's direct path) against the plain
   attention within 1e-4, K5 once per layer per call and its plain
   version never; the word2vec fit's table as a lookup record (rows
   equal to syn0's); ``GET /models``'s ``embed`` report and the
   ``retrieval_stats`` samples at ``/metrics``;
17. the serving path under ``DL4J_TPU_OBS=1`` (``phase_obs``, run right
   after the serving planes, with the journal in a temporary directory):
   a 64-request ``/predict`` burst on the char-RNN (one ``serve.request``
   span each, its request id in exactly one ``serve.batch`` span), the
   serve burst's 16 ``/generate`` requests (one ``decode.paged`` span per
   decode tick with ``lanes`` and ``tick_k``; the transcripts equal to the
   burst's) and 64 searches; a ``MetricsExporter`` scrape listing
   ``retrieval_stats``; ``/predict`` rows/s with obs off and on in three
   interleaved pairs; K1, K4 and K6 launches equal with obs off and on
   (one client: a batch per request); ``drain()`` leaving
   ``serve.drain`` and ``serve.drain_complete`` in the journal file;
18. ``/search`` (``phase_search``): ``VectorStore(768, kind="ivf")`` at its
   default capacity (``ann_arena_rows``: 1,048,576 rows on an 80 GB
   card), 1,000,000 rows around 1,000 centers at noise 0.05, made on the
   card and upserted from there 65,536 at a time, ``publish()`` with the IVF defaults (1,000
   clusters, nprobe 8, 25 iterations) and its seconds by stage (pack,
   k-means++ seeding, Lloyd steps, assignment, member table),
   ``report()`` and ``hbm_report``'s ``indexes`` beside the rise in
   ``memory_allocated``; exact ids and scores of 16 queries against an
   f64 scan of the host master (ids where the f64 scores at the rank are
   1e-5 apart, scores within 1e-4); IVF recall@10 against the exact index
   over 256 queries (>= 0.95); exact and IVF queries/s at B = 8 (median of
   5 x 1,024 queries) with each batch's device ms and bound; 256
   single-query ``POST /search`` calls (p50, p99); 2,048 passages of 128
   tokens through ``/embed`` of BERT-base (loaded through ``POST
   /models``; K5 12 launches a call, plain 0) into an exact store, every
   passage's embedding at rank 1, 64 re-embedded over HTTP at rank 1; a
   65,536-row IVF store searched by four HTTP clients while five
   ``feed_once`` windows (4,096 upserts, 1,024 deletes) publish
   generations 2-6 (no failed search, every answer inside one
   generation's live set); a window shifted by 5 sigma vetoed by a
   ``DriftMonitor`` on the corpus's moments (``feed_once`` and
   ``publish`` refused, the generation unmoved, two
   ``retrieval.publish_veto`` events in the journal);
19. the training runtime (``phase_runtime``), strict f32: (a) the
   full-width char-RNN of 6 for 24 steps under ``ResilientTrainer``, fed
   by ``InputPipeline(ListDataSetIterator(...))`` (2 workers, prefetch 4,
   the stager's pinned copies on a side stream) with async checkpoints
   every 4 steps (keep 2), in three child processes of this script with
   one seed: uninterrupted; SIGTERM after step 10 with a transient error
   before step 3 (retried once) and the step-10 checkpoint bit-flipped
   (``Preempted``, exit 3); a re-run that skips the corrupt checkpoint,
   resumes from step 8 and ends with params ``torch.equal`` and the loss
   tail equal to the uninterrupted run's; K1 and K2 4 launches a step in
   each child, the plain scans none; ms a step against the same fits on
   tensors on the card, the stall fraction, a save's async and sync
   stall, the checkpoint's MB, the seconds from the re-exec to the first
   resumed step; (b) LeNet-5 at batch 512 under ``EarlyStoppingTrainer``
   (MaxEpochs 3, ScoreImprovement patience 1, the held-out loss, a
   ``CheckpointManagerSaver``) fed by ``InputPipeline.from_native`` over
   the seeded MNIST stand-in written as idx files and read back with the
   port's native ``read_idx`` (8,192 training rows, 1,024 held out): the
   restored best model's score within 1e-6 of the best score, samples/s
   against direct fits; (c) ``bench.py``'s input_pipeline leg (a naive
   feed against ``InputPipeline.from_reader``, params ``torch.equal``
   after one pass each, samples/s) and checkpoint_overhead leg (the
   loop's stall per sync and async save, the checkpoint's MB);
20. distributed training on world-1 NCCL groups (``phase_distributed``):
   (a) the bench transformer with 8 experts a layer (top 2, capacity
   factor 1.25, aux 1e-2; bf16 compute, f32 masters; ~1.16 B params), 10
   ``fit`` and ``fit_batches`` of 4 at 16 x 1024 (finite, falling loss;
   K4 and K7 4 a step, plain 0; step ms, tokens/s, a profile, peak
   memory, the share of token slots dropped by capacity and the aux
   loss), then 32 tokens of ``generate`` with the KV cache (prefill
   through K4, the no-drop MoE decode); (b) 2 layers of it in strict f32
   at 8 x 1024: the ``data`` x ``model`` x ``expert`` (1 x 1 x 1) step
   ``torch.equal`` to the plain step, the GPipe step at 4 microbatches
   within 1e-4 of accumulation at 4, K4/K7 in both, each step's ms; (c)
   one ``ParallelWrapper`` step of ResNet-50 at 224 x 128 on the world-1
   ``'data'`` group ``torch.equal`` to ``net.fit`` (cuDNN deterministic
   for the pair); ``ParameterAveragingTrainingMaster`` with 4 in-process
   workers, frequency 5, 2 rounds on the char-RNN (K1/K2 4 a worker fit,
   plain 0) ``torch.equal`` to four nets fitted on their rows with params
   and RMSProp state averaged, samples/s against those fits;
   ``DistributedEarlyStoppingTrainer`` with MaxEpochs(2);
   ``DistributedEvaluator``'s merge equal to the serial evaluation; (d)
   ``save_lm``/``restore_lm`` of (a)'s LM (logits ``torch.equal``) and a
   ``CheckpointManager(backend="sharded")`` save and ``restore_latest``
   of the char-RNN, MB and seconds of each;
21. the serving fleet (``phase_fleet``), after the bench transformer is
   built again: (a) a ``ServingFleet`` of 2 thread replicas of it (each
   KV arena sized on ``KV_BUDGET``) with the char-RNN as a second record,
   behind a ``FleetRouter``: the serve burst's 17 ``/generate`` requests
   equal to one engine's transcripts, 64 ``/predict`` calls byte-equal to
   one engine's (sequential) and within 1e-5 (8 clients); tokens/s and
   rows/s through the router beside one engine's, the router's added p50
   over 50 single-row calls; ``RouterChaos`` kills r0 after 8 proxied
   calls of a 48-request burst: every request answered, the seconds from
   the kill to the ejection, the replica respawned; K4, K6 and K1
   launched, the plain versions never; (b) 2 OS-process replicas of the
   char-RNN zip (``python -m deeplearning4j_tpu_torch.serving.fleet``):
   answers byte-equal to (a)'s, SIGTERM (drain, goodbye) and SIGKILL
   (expiry) timed; (c) a prefill-role and a decode-role replica: the
   greedy requests equal to one engine's, the blocks and bytes handed
   off; the width-2 head-sharded tick (16 heads a shard, K6 on each) at
   64 lanes ``torch.equal`` to the dense tick; (d) a scripted ``/predict``
   wave (``AutoscaleChaos``) scales a char-RNN fleet 1 -> 3 -> 1 under 3
   clients with no failed request, the decisions replaying exactly;
   ``pack_models`` places the bench LM and the char-RNN on the card's
   memory; (e) ``ContinuousTrainer`` 3 rounds of 4 batches from a
   ``StreamSource`` (K1/K2 4 a step), then ``ShadowPromoter`` mirrors at
   fraction 0.5 (the primary's answers byte-equal with mirroring on and
   off) and promotes the candidate zip under 4 clients with no failed
   request; (f) ``ElasticParameterAveragingTrainer`` with 4 workers on
   the char-RNN, a split killed in round 1 (reclaimed) and a worker
   admitted at round 3, params ``torch.equal`` to the replay of that
   membership sequence, K1/K2 4 a worker fit, samples/s; (g)
   ``Word2Vec(num_workers=1)`` on a world-1 NCCL group ``torch.equal`` to
   the plain fit, K3 once a batch;
22. prints one ``{"kernels": [...]}`` line, the card line again, and last
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Right after the word2vec phase, ``phase_embeddings`` drives the NLP,
graph and t-SNE models on the word2vec corpus: (a) ParagraphVectors DBOW
at the word2vec widths on all 10,000 sentences, each labelled
``TOPIC_<t>`` (the word co-training's pairs/s and K3 once a co-training
batch, the plain step never; the DBOW loop's pairs/s; ``infer_vector`` ms
and the top-1 ``nearest_labels`` agreement on 200 held-out sentences
against ``PV_AGREEMENT_CPU``); (b) DM on the first 2,000 sentences; (c)
GloVe on the first 2,000 (pairs, the count's host seconds, pairs/s, a
loss that falls every epoch); (d) DeepWalk on a seeded stochastic block
model of 100 communities of 100 vertices (walk and pair host seconds,
pairs/s, the community share of each of 500 vertices' 10 nearest
against ``DW_COMMUNITY_CPU``); (e) exact t-SNE of the word2vec fit's
5,000 most frequent words for 1,000 iterations (``_input_p`` host
seconds, a step's device ms against its bound, the KL falling, peak
memory); (f) one step of each device function (``dbow_step``,
``dm_step``, ``infer_dbow_step``, ``glove_step``, ``hs_body``,
``tsne_step``) on the card against the CPU within 1e-5 of each output's
largest entry; (g) ``generate`` of the bench transformer in the Megatron
mode on a world-1 NCCL group ``torch.equal`` to the model with no group
(both samplers), its prefill through K4. To rehearse (a) and (d) on the
CPU: ``python3 -c "import chip_smoke; chip_smoke.embeddings_rehearsal()"``
(~75 s with ``OMP_NUM_THREADS=4``).

Right after it, ``phase_tooling`` drives the tooling entry points on
the card, reusing the word2vec fit: (a) the north star
(``utils/equivalence.run_north_star(steps=100)``): LeNet-5 at batch 64 on
the MNIST stand-in and the char-RNN (vocab 40, one layer of 64, TBPTT
16, batch 16, seq 32), each trained once on the card's host CPU and once
on the card from the same initial state; both final losses, the max
absolute and relative deviation of the curves and the first step past
1e-3. Each curve is held at a max relative deviation of 1e-3 or, where
the CPU's own curve moves further when its start moves one ulp (three
seeded runs from a start with every parameter ``nextafter``'d up or
down), at twice the largest such spread: the char-RNN's RMSProp at lr 0.1
turns a one-ulp change into 5-6 % of the loss by step 4 on the CPU
alone, so no f32 implementation that sums in another order holds 1e-3
there. The first step, a forward with no update yet, is held at 1e-5;
K1 and K2 200 launches each in the card's char-RNN leg, the plain scans
0; (b) the CLI: ``main(["train", ...], device=card)`` on a
``--conf`` of the full-width char-RNN (``char_rnn_conf(80,
lstm_size=200)``, two layers, TBPTT 50) and an ``.npz`` of 8 batches of
32 x 100 one-hot Markov text (K1 and K2 4 a fit, the plain scans 0; the
seconds and the final score); ``train``, ``test`` and ``predict`` of an
MLP on an iris CSV from ``load_iris`` (accuracy >= 0.9), and the same
``predict`` as a subprocess (``python -m deeplearning4j_tpu_torch.cli``)
whose CSV is byte-equal to the in-process one; (c) the UI:
``UiServer(device=card)`` on port 0; 8 fits of the full-width char-RNN
under ``HistogramIterationListener(frequency=2)``,
``FlowIterationListener(frequency=2)`` (both posting over HTTP),
``PerformanceListener``, ``DispatchStatsListener`` and
``XplaneTraceListener(start_iteration=2, num_iterations=3)``: the last
histogram in ``GET /train/summary`` equal to ``numpy.histogram`` of the
parameters copied off the card at that iteration, the Chrome trace naming
K1's (``lstm_fwd_cluster``) and K2's kernels, ``link_stats``'s event in a
``TrainingStats``, K1 and K2 4 a fit; 4 LeNet-5 fits under
``ConvolutionalIterationListener`` (finite grids); ``POST /tsne/upload``
of the word2vec fit's 1,000 most frequent words at perplexity 30,
``torch.equal`` to ``Tsne(device=card)`` called directly; ``POST
/word2vec/upload`` of 5,000 words and 100 ``/word2vec/nearest`` queries
at k = 10, equal to a brute-force cosine (normalized Euclidean) top 10,
ties aside, ms a query; (d) the host text tools on the word2vec corpus:
``TextPipeline(num_partitions=8)`` gives the word2vec phase's vocab and
Huffman codes word for word (its seconds beside the serial build's); a
``TfidfVectorizer`` ``DataSet`` of the sentences of 10 topics trains a
one-hidden-layer MLP on the card for 2 epochs, each step's loss within
1e-3 relative of the same fit on the CPU; ``TreeParser`` parses 200
sentences, one tree each; 10 ``InvertedIndex`` lookups equal a scan of
the corpus; (e) ``launches_tooling`` in K1's and K2's entries of the
kernels line. To rehearse (a) and (d) on the CPU: ``python3 -c "import
chip_smoke; chip_smoke.tooling_rehearsal()"`` (~22 s with
``OMP_NUM_THREADS=4``; both north-star legs on the CPU, deviation 0).

Phase 7 also breaks a decode tick, a width-1024 prefill, a batch-64
``output()`` and one ``fit`` down by kernel with ``torch.profiler``.
``--out PATH`` also writes the whole report as JSON.
"""

from __future__ import annotations

import argparse
import base64
import copy
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import warnings
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from deeplearning4j_tpu_torch.etl.calibrate import QuantCalibrator  # noqa: E402
from deeplearning4j_tpu_torch.etl.normalize import (  # noqa: E402
    NormalizerStandardize,
)
from deeplearning4j_tpu_torch.models.char_rnn import (  # noqa: E402
    CharRnn,
    char_rnn_conf,
)
from deeplearning4j_tpu_torch.models import bert as bert_mod  # noqa: E402
from deeplearning4j_tpu_torch.models import transformer as lm_mod  # noqa: E402
from deeplearning4j_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig,
    TransformerLM,
    forward,
    prefill_cache,
    ring_forward,
)
from deeplearning4j_tpu_torch.nlp.serializer import (  # noqa: E402
    load_word2vec,
    save_word2vec,
)
from deeplearning4j_tpu_torch.nlp.word2vec import (  # noqa: E402
    SkipgramGraphs,
    Word2Vec,
    replay_draw,
    skipgram_batches,
    unigram_draw,
)
from deeplearning4j_tpu_torch.datasets.fetchers import (  # noqa: E402
    _synthetic_mnist,
    load_mnist_info,
)
from deeplearning4j_tpu_torch.datasets.records import (  # noqa: E402
    CSVRecordReader,
    RecordReaderDataSetIterator,
)
from deeplearning4j_tpu_torch import earlystopping as es_mod  # noqa: E402
from deeplearning4j_tpu_torch import native  # noqa: E402
from deeplearning4j_tpu_torch import resilience as pres  # noqa: E402
from deeplearning4j_tpu_torch.etl.pipeline import InputPipeline  # noqa: E402
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator  # noqa: E402
from deeplearning4j_tpu_torch.models.alexnet import build_alexnet  # noqa: E402
from deeplearning4j_tpu_torch.models.dbn import (  # noqa: E402
    build_dbn,
    build_stacked_autoencoder,
)
from deeplearning4j_tpu_torch.models.lenet import (  # noqa: E402
    INPUT_SHAPE as LENET_INPUT,
    build_lenet5,
    lenet5_conf,
)
from deeplearning4j_tpu_torch.models.googlenet import build_googlenet  # noqa: E402
from deeplearning4j_tpu_torch.models.resnet import build_resnet50  # noqa: E402
from deeplearning4j_tpu_torch.models.vgg import build_vgg16  # noqa: E402
from deeplearning4j_tpu_torch.nn import conf as nn_conf  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (  # noqa: E402
    CnnToFeedForwardPreProcessor,
    ReshapePreProcessor,
)
from deeplearning4j_tpu_torch.nn.conf import graph as graph_conf  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import layers as L  # noqa: E402
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.datasets.iterator import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.obs import journal as obs_journal  # noqa: E402
from deeplearning4j_tpu_torch.obs import registry as obs_registry  # noqa: E402
from deeplearning4j_tpu_torch.obs import trace as obs_trace  # noqa: E402
from deeplearning4j_tpu_torch.obs import (  # noqa: E402
    FlightRecorder,
    MetricsExporter,
)
from deeplearning4j_tpu_torch.online import (  # noqa: E402
    DriftMonitor,
    StreamSource,
)
from deeplearning4j_tpu_torch.retrieval import (  # noqa: E402
    PublishVetoed,
    VectorStore,
)
from deeplearning4j_tpu_torch.retrieval.index import (  # noqa: E402
    _exact_topk,
    _ivf_topk,
)
from deeplearning4j_tpu_torch.ops import build  # noqa: E402
from deeplearning4j_tpu_torch.ops import lowprec  # noqa: E402
from deeplearning4j_tpu_torch.ops.memory import (  # noqa: E402
    ann_arena_rows,
    kv_arena_blocks,
)
from deeplearning4j_tpu_torch.ops.dispatch import bucket_size  # noqa: E402
from deeplearning4j_tpu_torch.ops import flash_attention as flash_mod  # noqa: E402
from deeplearning4j_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_block,
    flash_attention_block_plain,
    flash_attention_plain,
    flash_block_bwd,
    flash_bwd,
)
from deeplearning4j_tpu_torch.nn.layers import recurrent  # noqa: E402
from deeplearning4j_tpu_torch.ops.lstm_scan import (  # noqa: E402
    lstm_scan,
    lstm_scan_bwd,
    lstm_scan_bwd_plain,
    lstm_scan_plain,
)
from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: E402
    CollectScoresIterationListener,
)
from deeplearning4j_tpu_torch.ops.paged_attention import (  # noqa: E402
    paged_attention,
    paged_attention_plain,
)
from deeplearning4j_tpu_torch.ops.sgns import (  # noqa: E402
    WARP_HITS,
    hit_lists,
    sgns_step,
    sgns_step_plain,
)
from deeplearning4j_tpu_torch.parallel.mesh import init_seq_group  # noqa: E402
from deeplearning4j_tpu_torch.parallel.sequence_parallel import (  # noqa: E402
    ring_flash_finish,
    ring_flash_init,
    ring_flash_step,
)
from deeplearning4j_tpu_torch.resilience import (  # noqa: E402
    InjectedServingFault,
    ServingChaos,
    ServingChaosConfig,
    SpecChaos,
    SpecChaosConfig,
)
from deeplearning4j_tpu_torch.serving.decode import (  # noqa: E402
    _sample_step,
    _tick_for,
)
from deeplearning4j_tpu_torch.serving.engine import ServingEngine  # noqa: E402
from deeplearning4j_tpu_torch.serving.paged import (  # noqa: E402
    _paged_tick_for,
    paged_decode_step,
)
from deeplearning4j_tpu_torch.serving.speculate import (  # noqa: E402
    SpeculativeDecoder,
    _verify_for,
)
from deeplearning4j_tpu_torch.utils.serialization import (  # noqa: E402
    tree_to_npz_bytes,
    write_model,
)

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (data sheet)
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor cores (data sheet)
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores
# f32 products at f32 accuracy on the tensor cores: 3xTF32, three TF32
# products (495 TFLOP/s dense, data sheet) per f32 product; K5's f32 bound
PEAK_F32_TC_FLOPS = 495e12 / 3
# the cluster barrier (barrier.cluster.arrive / wait) in SASS: K1's and
# K2's clusters meet at it at their start and end
CLUSTER_BARRIER_SASS = ("UCGABAR_ARV", "UCGABAR_WAIT")
TOL_FLASH_O = 2e-2           # bf16 in, f32 math, O rounded to bf16
TOL_FLASH_LSE = 1e-3         # f32 lse from bf16 inputs
TOL_PAGED = 1e-3             # f32 output from a bf16 arena
TOL_LSTM = 1e-4              # f32 in and out, sums in another order
TOL_LSTM_BWD = 1e-4          # abs on dxproj, dh0, dc0; of the largest
                             # entry on dU and dp (sums of N*T products)
TOL_GRAD = 1e-4              # of each gradient leaf's largest entry
TOL_PREDICT = 1e-5           # batched answer vs the same rows alone
FLASH_WIDTHS = (192, 512, 1024)
ONE_P = ("-DFLASH_P_SPLIT=0",)  # the K4/K5 variant with one bf16 P in P.V
H, HD, BT, M_TABLE, LANES = 32, 64, 16, 64, 64
N_REQUESTS, N_CLIENTS = 16, 8  # plus one streamed request
# the decode planes: proposals per speculative round, and the budget both
# KV-dtype arenas are priced on (ops/memory.kv_arena_blocks)
SPEC_K, KV_BUDGET = 4, 4 * 2**30
KERNELS = (flash_attention, flash_attention_plain, paged_attention,
           paged_attention_plain)
# K1: the char-RNN at full width (N=64 rows, T=100, H=200), then the
# shape classes of benchmarks/pallas_lstm_bench.py
LSTM_SHAPES = ((64, 100, 200), (32, 128, 128), (64, 256, 256),
               (128, 512, 512))
VOCAB, SEQ, LSTM_H = 80, 100, 200  # bench.py:206
N_PREDICT, MAX_ROWS = 64, 4        # /predict requests, rows per request
# K2: the char-RNN's training window (N=32, TBPTT 50), a full-batch
# /predict shape, then the shape classes of benchmarks/pallas_lstm_bench.py
BWD_SHAPES = ((32, 50, 200), (64, 100, 200), (32, 128, 128),
              (64, 256, 256), (128, 512, 512))
TRAIN_BATCH, TBPTT, N_FITS = 32, 50, 30  # bench.py:206-222
# bench.py trains at char_rnn_conf's lr 0.1, where RMSProp's first step
# moves every weight by lr / sqrt(1 - 0.95) = 0.447 and the loss of this
# net blows up for tens of fits (the JAX package's trajectory too); 0.003
# learns the chain within 30 fits. The kernels' work is the same.
TRAIN_LR = 0.003
# K3: the smoke's word2vec (V, D, B, K+1), then the hot class of
# bench.py:764 (its shape only)
SGNS_SHAPES = ((71290, 128, 2048, 6), (100_000, 100, 1024, 6))
TOL_SGNS = 1e-5  # of the largest entry of each table's update (f32 sums)
# word2vec: bench.py:3433's model (layer 128, window 5, 5 negatives, batch
# 2048, 1 epoch) at min count 5, the cut that gives text8's 71,290 words
W2V_VOCAB, W2V_TOPICS, W2V_SENT, W2V_SENTENCES = 71290, 100, 100, 10_000
W2V_MIN_COUNT, W2V_NOISE = 5, 0.1
W2V_D, W2V_WINDOW, W2V_NEG, W2V_BATCH = 128, 5, 5, 2048
W2V_QUERY_WORDS, W2V_TOP_N = 1000, 10
# topic agreement of the 10 nearest neighbours of the 1,000 most frequent
# words after the same fit on the CPU (device="cpu", seed 0: the smoke's
# corpus and configuration, the plain SGNS step, the CPU generator's
# negatives), from chip_smoke.w2v_rehearsal: 5,857,208 pairs in 2,860
# batches, agreement 0.9368
W2V_AGREEMENT_CPU = 0.9368
# the agreement comes from syn0, which HS trains too; the negative-sampling
# margin (ns_margin) reads syn1neg, which only K3 writes: 0 if K3 wrote
# nothing. Its value after the same CPU fit, from chip_smoke.w2v_rehearsal
# (the chunk's draws from the CPU generator); over three chunks of other
# pairs and draws it gave 0.0411-0.0419
W2V_NS_MARGIN_CPU = 0.04186078906059265
# K5: the ring-local shape of bench.py:522 (N, T, H, D) and the masked
# shape of bench.py:581, ~80 % of keys kept
EXT_RING, EXT_MASKED, EXT_KEEP = (1, 4096, 8, 64), (4, 2048, 8, 64), 0.8
TOL_EXT_F32 = 1e-4            # K5 in f32: O and lse
RING_SHARDS = 4               # the in-process ring
# ring_forward on the bench transformer at bench.py:522's T, and in f32
RING_T, RING_T_F32 = 4096, 1024
TOL_RING_BF16 = 5e-2          # bf16 logits, ring (K5) against forward (K4)
TOL_RING_F32 = 1e-3           # f32 logits, the same two paths
# the masked MultiHeadAttention network: 2 MHA(512, 8 heads) layers
MHA_N, MHA_T, MHA_F, MHA_W, MHA_HEADS, MHA_CLASSES = 32, 512, 64, 512, 8, 16
MHA_FITS, MHA_LR = 20, 1e-3
# K7, the flash backward: of the largest entry of each gradient (bf16: P
# and dS rounded to bf16 for their products; f32: 3xTF32)
TOL_BWD_BF16, TOL_BWD_F32 = 1e-2, 1e-4
# the LM's training: bench.py:371 bench_transformer, batch 16 x T=1024 at
# _transformer_bench_cfg's lr (bench.py:356); 5 fits, then fit_batches of 5
LM_BATCH, LM_T, LM_LR, LM_FITS, LM_MULTI = 16, 1024, 1e-4, 5, 5
LM_SUCCESSORS = 4  # the token stream: a Markov chain of 4 successors a token
# the ring's training: the bench transformer at max_len RING_T, a global
# batch of 4 x T=4096 (16,384 tokens a step, the LM phase's count); 3 fits,
# fit_batches of 3, then 3 Ulysses steps
RT_N, RT_T, RT_FITS, RT_MULTI, RT_ULYSSES = 4, RING_T, 3, 3, 3
# the ring step against the dense step at the card LM step test's bars
# (tests/test_torch_gpu.py): the loss within 1e-2 relative, the attention
# weights within 1e-2 of each leaf's largest entry, the rest 2e-2 (bf16
# roundings of the two paths differ)
TOL_STEP_LOSS, TOL_STEP_REST = 1e-2, 2e-2
# BERT-base widths (google-research/bert uncased_L-12_H-768_A-12
# bert_config.json) in the repo's encoder (pre-LN, no segment embeddings,
# no pooler), strict f32, Adam lr 1e-4; batch 16 x T=512, lengths 128-512
BERT_KW = dict(vocab_size=30522, d_model=768, n_layers=12, n_heads=12,
               d_ff=3072, max_len=512, pad_token_id=0, mask_token_id=103,
               learning_rate=1e-4)
BERT_N, BERT_T, BERT_MIN_LEN, BERT_FITS, BERT_MULTI = 16, 512, 128, 5, 3
# the serving planes: the lowprec bench's MLP (bench.py:2876-2891: 256-512-
# 512-10, 4 Adam fits of 128 rows, calibrated on 256 rows) and the
# resilience bench's (bench.py:1431-1437: 256-256-128-10); /predict
# requests of 1-8 rows
LOWPREC_MLP, RESIL_MLP, QUANT_BATCH = (256, 512, 512, 10), \
    (256, 256, 128, 10), 256
MLP_MAX_ROWS = 8
PLANES_WATCHDOG_S, PLANES_COOLDOWN_S = 2.0, 1.0
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor cores (data sheet)
# fine-tuning on a planted two-class label: 10 steps of 16 rows, then the
# accuracy on 64 held-out rows of the same law
FT_STEPS, FT_HELD_OUT, FT_ACCURACY = 10, 64, 0.75
# the CNN and layer-zoo phase: LeNet-5 at bench.py:115's protocol (batch
# 512 over 4 rotating batches, 30 fits after 3 warm-up ones) and
# bench.py:144's fused form (fit_batches of K=32, 3 times); AlexNet's
# output at 128 and 5 steps at 128; VGG16's 3 steps at 32; the DBN and the
# stacked autoencoder on 8 batches of 128, 10 fine-tune steps; the
# Solver's iterations; the Embedding-LSTM's fits
LENET_BATCH, LENET_FITS, LENET_K, LENET_REPS = 512, 30, 32, 3
ALEX_SIZE, ALEX_OUT_BATCH, ALEX_BATCH, ALEX_STEPS = 227, 128, 128, 5
VGG_SIZE, VGG_BATCH, VGG_STEPS = 224, 32, 3
PRE_BATCH, PRE_BATCHES, PRE_FINETUNE = 128, 8, 10
SOLVER_ITERS, ZOO_FITS = 5, 10
TOL_CARD_CPU = 1e-4  # of the largest entry: the card against the CPU, f32
# the ComputationGraph phase: ResNet-50 at bench.py:271-330's leg (batch
# 128 at 224, Nesterovs lr 0.05; strict f32 here), GoogLeNet with its aux
# heads at batch 64, the seq2seq graph at the char-RNN's widths, and the
# bf16 loss-scaled steps of LeNet-5 and ResNet-50
RESNET_SIZE, RESNET_BATCH, RESNET_STEPS, RESNET_LR = 224, 128, 10, 0.05
GOOG_SIZE, GOOG_BATCH, GOOG_STEPS = 224, 64, 3
F32_NOISE_FACTOR = 4  # the card's f32 step against f64: x the CPU's error
S2S_FITS, BF16_STEPS = 10, 5
# /embed: the retrieval bench's MLP (bench.py:3041-3048: 16 -> 64 relu ->
# 4) and its 128 single-row calls (phase 3); BERT's token rows
EMBED_MLP, EMBED_CALLS = (16, 64, 4), 128
EMBED_BERT_N, EMBED_BERT_T = 4, 128
TOL_EMBED = 1e-5  # the batcher against the direct call, f32
# /search: a 768-wide index (BERT-base's hidden size) of 1,000,000 rows
# around 1,000 centers at noise 0.05 (bench.py:2994-3003's regime), at the
# capacity the store sizes itself to on an 80 GB card (the 1 << 20 clamp
# of ops/memory.ann_arena_rows), upserted 65,536 rows at a time
SEARCH_DIM, SEARCH_ROWS, SEARCH_CENTERS, SEARCH_NOISE = 768, 1_000_000, \
    1000, 0.05
SEARCH_CAPACITY, SEARCH_BATCH = 1 << 20, 65_536
# exact ids against an f64 host scan on 16 queries (compared where the
# f64 scores at the rank are 1e-5 apart), IVF recall@10 on 256, queries/s
# at B = 8 over 1,024 queries (median of 5), 256 HTTP calls
SEARCH_K, SEARCH_B, SEARCH_REPS = 10, 8, 5
SEARCH_ORACLE_Q, SEARCH_RECALL_Q, SEARCH_QPS_Q = 16, 256, 1024
SEARCH_HTTP_CALLS, SEARCH_MARGIN, SEARCH_SCORE_TOL = 256, 1e-5, 1e-4
# the BERT leg: 2,048 passages of 128 tokens, /embed calls of 64 rows, 64
# queries
SEARCH_PASSAGES, SEARCH_PASSAGE_T, SEARCH_EMBED_ROWS, SEARCH_BERT_Q = \
    2048, 128, 64, 64
# the swap under load: bench.py's 65,536 rows, 5 feed windows of 4,096
# upserts and 1,024 deletes
SWAP_ROWS, SWAP_WINDOWS, SWAP_UPSERTS, SWAP_DELETES = 65_536, 5, 4096, 1024


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def short_name(mangled: str) -> str:
    try:
        out = subprocess.run(["c++filt", mangled], capture_output=True,
                             text=True, timeout=10)
        name = out.stdout.strip() or mangled
    except OSError:
        name = mangled
    return name.replace("(anonymous namespace)::", "").split("(")[0] \
        .replace("__nv_bfloat16", "bf16")


def phase_build():
    print("== build (nvcc -gencode arch=compute_90a,code=sm_90a) ==")
    for res in build.build(["flash_attention", "paged_attention",
                            "lstm_scan", "lstm_scan_bwd", "sgns",
                            "flash_bwd"]):
        print(f"built {res.name}: {res.seconds:.1f} s -> "
              f"{os.path.relpath(res.path)}")
        fn = None
        for line in res.log.splitlines():
            if "Compiling entry function" in line:
                fn = short_name(line.split("'")[1])
            elif "Used" in line and "registers" in line and fn:
                print(f"  ptxas {fn}: {line.split(':', 1)[-1].strip()}")
            elif "spill stores" in line and fn:
                print(f"  ptxas {fn}: {line.split(':', 1)[-1].strip()}")
    # the K4/K5 library (csrc/flash_fwd.cuh's kernels): its bf16 kernels
    # must issue wgmma (HGMMA), its f32 ones TF32 tensor-core products
    # (HMMA ... TF32: 3xTF32 on mma.sync), and both copy K/V with
    # cp.async (LDGSTS)
    text = build.sass("flash_attention")
    sass = {op: text.count(op) for op in ("HGMMA", "LDGSTS")}
    sass["HMMA_TF32"] = sum(1 for line in text.splitlines()
                            if "HMMA" in line and "TF32" in line)
    print("  cuobjdump -sass flash_attention: " + ", ".join(
        f"{op} x{c}" for op, c in sass.items()))
    check(sass["HGMMA"] > 0 and sass["LDGSTS"] > 0 and sass["HMMA_TF32"] > 0,
          "flash_attention: no wgmma (HGMMA), TF32 mma (HMMA ... TF32) or "
          "cp.async (LDGSTS) instruction in its SASS")
    # K1 and K2: the clusters' barrier (at their start and end) and the
    # per-step DSMEM exchange (st.async: STAS, counted on an mbarrier);
    # K2's two products run 3xTF32 on the tensor cores (HMMA ... TF32)
    for name in ("lstm_scan", "lstm_scan_bwd"):
        text = build.sass(name)
        found = {op: text.count(op) for op in CLUSTER_BARRIER_SASS}
        found["STAS"] = text.count("STAS")
        if name == "lstm_scan_bwd":
            found["HMMA_TF32"] = sum(1 for line in text.splitlines()
                                     if "HMMA" in line and "TF32" in line)
        print(f"  cuobjdump -sass {name}: " + ", ".join(
            f"{op} x{c}" for op, c in found.items()))
        check(all(found.values()), f"{name}: no cluster barrier "
              f"({' / '.join(CLUSTER_BARRIER_SASS)}), DSMEM store (STAS) "
              "or, in K2, TF32 tensor-core product in its SASS")
        sass[name] = found
    # K7: every bf16 kernel multiplies by wgmma (HGMMA), every f32 kernel
    # by 3xTF32 on mma.sync (HMMA ... TF32), and every kernel takes its
    # tiles by cp.async (LDGSTS)
    found = bwd_sass(build.sass_functions(build.sass("flash_bwd")))
    print("  cuobjdump -sass flash_bwd: " + ", ".join(
        f"{op} {c}" for op, c in found.items()))
    check(found["kernels_bf16"] > 0 and found["kernels_f32"] > 0
          and found["bf16_with_HGMMA_LDGSTS"] == found["kernels_bf16"]
          and found["f32_with_HMMA_TF32_LDGSTS"] == found["kernels_f32"],
          "flash_bwd: a bf16 kernel without wgmma (HGMMA) or an f32 kernel "
          "without TF32 mma (HMMA ... TF32), or one without cp.async "
          "(LDGSTS), in its SASS")
    sass["flash_bwd"] = found
    (res,) = build.build(["flash_attention"], ONE_P)
    print(f"built flash_attention {' '.join(ONE_P)}: {res.seconds:.1f} s")
    return sass


def bwd_sass(kernels: dict) -> dict:
    """Counts of K7's kernels (``build.sass_functions`` of its library) by
    type, and of those whose SASS holds what their design issues: bf16
    wgmma (HGMMA), f32 TF32 tensor-core products (HMMA ... TF32), both
    cp.async (LDGSTS)."""
    bf = {n: t for n, t in kernels.items() if "flash_bwd" in n
          and "__nv_bfloat16" in n}
    f32 = {n: t for n, t in kernels.items() if "flash_bwd" in n
           and n not in bf}
    tf32 = lambda t: any("HMMA" in ln and "TF32" in ln
                         for ln in t.splitlines())
    return {"kernels_bf16": len(bf), "kernels_f32": len(f32),
            "bf16_with_HGMMA_LDGSTS": sum("HGMMA" in t and "LDGSTS" in t
                                          for t in bf.values()),
            "f32_with_HMMA_TF32_LDGSTS": sum(tf32(t) and "LDGSTS" in t
                                             for t in f32.values())}


def flash_inputs(t: int, seed: int, dev):
    g = torch.Generator(device=dev).manual_seed(seed + t)
    return [torch.randn((1, t, H, HD), generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(3)]


def paged_inputs(seed: int, dev, n_blocks: int = 4096,
                 skewed: bool = False):
    """64 lanes over a bf16 arena of ``n_blocks`` (+ trash): positions
    inside block 0, across blocks, and at the full window; ``skewed``:
    one lane at the full window and 63 at 16 tokens (what K6's context
    splits are for)."""
    rng = np.random.default_rng(seed)
    t_max = M_TABLE * BT
    pos = rng.integers(0, t_max, LANES).astype(np.int32)
    pos[:8] = rng.integers(0, BT, 8)      # inside block 0
    pos[8:12] = t_max - 1                 # the full window
    if skewed:
        pos[:] = BT - 1
        pos[0] = t_max - 1
    tables = np.zeros((LANES, M_TABLE), np.int32)
    perm = rng.permutation(np.arange(1, n_blocks + 1))
    nxt = 0
    for i in range(LANES):
        used = int(pos[i]) // BT + 1
        tables[i, :used] = perm[nxt:nxt + used]
        nxt += used
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (n_blocks + 1, BT, H, HD)
    ck = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    cv = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    q = torch.randn((LANES, H, HD), generator=g, device=dev,
                    dtype=torch.bfloat16)
    return (q, ck, cv, torch.from_numpy(tables).to(dev),
            torch.from_numpy(pos).to(dev))


def phase_kernels(seed: int, dev):
    print("== kernels against their plain versions ==")
    err_o = err_lse = 0.0
    for t in FLASH_WIDTHS:
        q, k, v = flash_inputs(t, seed, dev)
        o, lse = flash_attention(q, k, v, causal=True)
        ro, rlse = flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        eo = (o.float() - ro.float()).abs().max().item()
        el = (lse - rlse).abs().max().item()
        print(f"flash_attention T={t}: max|dO| {eo:.3e} (tol "
              f"{TOL_FLASH_O}), max|dlse| {el:.3e} (tol {TOL_FLASH_LSE})")
        check(eo <= TOL_FLASH_O and el <= TOL_FLASH_LSE,
              f"flash_attention disagrees with its plain version at T={t}")
        err_o, err_lse = max(err_o, eo), max(err_lse, el)
    err_p = 0.0
    for skewed in (False, True):
        q, ck, cv, tables, pos = paged_inputs(seed, dev, skewed=skewed)
        out = paged_attention(q, ck, cv, tables, pos)
        again = paged_attention(q, ck, cv, tables, pos)
        ref = paged_attention_plain(q, ck, cv, tables, pos)
        torch.cuda.synchronize()
        e = (out - ref).abs().max().item()
        same = torch.equal(out, again)
        print(f"paged_attention S={LANES} m={M_TABLE} pos in "
              f"[{int(pos.min())}, {int(pos.max())}]"
              f"{' (one long lane)' if skewed else ''}: max|d| {e:.3e} "
              f"(tol {TOL_PAGED}); two launches bit-equal: {same}")
        check(e <= TOL_PAGED,
              "paged_attention disagrees with its plain version")
        check(same, "two paged_attention launches differ")
        ck[0], cv[0] = 1e6, -1e6
        poisoned = paged_attention(q, ck, cv, tables, pos)
        torch.cuda.synchronize()
        check(torch.equal(out, poisoned),
              "a poisoned trash block moved an active lane's output")
        print("paged_attention: trash block poisoned (K=1e6, V=-1e6): "
              "outputs bit-equal")
        err_p = max(err_p, e)
    # K6's f32-query, bf16-arena instantiation (an f32 model over a
    # DL4J_TPU_SERVE_KV_DTYPE=bf16 arena), at the smoke's mix
    q, ck, cv, tables, pos = paged_inputs(seed, dev)
    q = q.float()
    out = paged_attention(q, ck, cv, tables, pos)
    again = paged_attention(q, ck, cv, tables, pos)
    ref = paged_attention_plain(q, ck, cv, tables, pos)
    torch.cuda.synchronize()
    err_pf = (out - ref).abs().max().item()
    same = torch.equal(out, again)
    print(f"paged_attention f32 q over a bf16 arena S={LANES} m={M_TABLE}: "
          f"max|d| {err_pf:.3e} (tol {TOL_PAGED}); two launches bit-equal: "
          f"{same}")
    check(err_pf <= TOL_PAGED, "paged_attention (f32 q, bf16 arena) "
          "disagrees with its plain version")
    check(same, "two paged_attention launches (f32 q, bf16 arena) differ")
    ck[0], cv[0] = 1e6, -1e6
    poisoned = paged_attention(q, ck, cv, tables, pos)
    torch.cuda.synchronize()
    check(torch.equal(out, poisoned), "a poisoned trash block moved an "
          "active lane's output (f32 q, bf16 arena)")
    print("paged_attention f32 q over a bf16 arena: trash block poisoned: "
          "outputs bit-equal")
    err_l = 0.0
    for n, t, h in LSTM_SHAPES + ((1, 8, LSTM_H),):
        args = lstm_inputs(n, t, h, seed, dev)
        for emit_cs in (False, True):
            out = lstm_scan(*args, emit_cs=emit_cs)
            again = lstm_scan(*args, emit_cs=emit_cs)
            ref = lstm_scan_plain(*args, emit_cs=emit_cs)
            torch.cuda.synchronize()
            errs = [(a - b).abs().max().item() for a, b in zip(out, ref)
                    if b is not None]
            same = all(a is None or torch.equal(a, b)
                       for a, b in zip(out, again))
            names = "hs h_T c_T cs".split()[:len(errs)]
            print(f"lstm_scan N={n} T={t} H={h} emit_cs={emit_cs}: " + ", ".join(
                f"max|d{k}| {e:.3e}" for k, e in zip(names, errs))
                + f" (tol {TOL_LSTM}); two launches bit-equal: {same}")
            check(max(errs) <= TOL_LSTM and (out[3] is None) != emit_cs,
                  f"lstm_scan disagrees with its plain version at "
                  f"N={n} T={t} H={h} emit_cs={emit_cs}")
            check(same, f"two lstm_scan launches differ at N={n} T={t} "
                  f"H={h} emit_cs={emit_cs}")
            err_l = max(err_l, *errs)
    err_b = abs_b = 0.0
    for n, t, h in BWD_SHAPES + ((1, 8, LSTM_H),):
        args = lstm_bwd_inputs(n, t, h, seed, dev)
        out = lstm_scan_bwd(*args)
        again = lstm_scan_bwd(*args)
        ref = lstm_scan_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = bwd_errors(out, ref)
        same = all(torch.equal(a, b) for a, b in zip(out, again))
        print(f"lstm_scan_bwd N={n} T={t} H={h}: " + ", ".join(
            f"{k} {e:.3e}" for k, e in zip(
                ("max|ddxproj|", "max|ddU|/max|dU|", "max|ddp|/max|dp|",
                 "max|ddh0|", "max|ddc0|"), errs))
            + f" (tol {TOL_LSTM_BWD}); two launches bit-equal: {same}")
        check(max(errs) <= TOL_LSTM_BWD,
              f"lstm_scan_bwd disagrees with its plain version at "
              f"N={n} T={t} H={h}")
        check(same, f"two lstm_scan_bwd launches differ at N={n} T={t} "
              f"H={h}")
        err_b = max(err_b, *errs)
        abs_b = max(abs_b, *((a - b).abs().max().item()
                             for a, b in zip(out, ref)))
    return {"flash_attention": {"max_abs_err": err_o,
                                "max_abs_err_lse": err_lse},
            "paged_attention": {"max_abs_err": err_p},
            "paged_attention_f32q": {"max_abs_err": err_pf},
            "lstm_scan": {"max_abs_err": err_l},
            "lstm_scan_bwd": {"max_err": err_b, "max_abs_err": abs_b}}


def lstm_inputs(n: int, t: int, h: int, seed: int, dev):
    """xproj, U, p, h0, c0 in f32 at the scale a trained layer sees:
    gate pre-activations of order 1."""
    g = torch.Generator(device=dev).manual_seed(seed + n + t + h)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)
    return (r(n, t, 4 * h), r(h, 4 * h) / h ** 0.5, 0.1 * r(3, h),
            0.1 * r(n, h), 0.1 * r(n, h))


def lstm_bwd_inputs(n: int, t: int, h: int, seed: int, dev):
    """K2's inputs: K1's, the forward's cs and hs, and unit-scale
    cotangents of hs, h_T and c_T."""
    x, u, p, h0, c0 = lstm_inputs(n, t, h, seed, dev)
    hs, _, _, cs = lstm_scan(x, u, p, h0, c0, emit_cs=True)
    g = torch.Generator(device=dev).manual_seed(seed + 7 * n + t + h)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)
    return x, u, p, h0, c0, cs, hs, r(n, t, h), r(n, h), r(n, h)


def bwd_errors(out, ref):
    """Max abs error on dxproj, dh0, dc0; max error over the largest
    entry on dU and dp (sums of N*T products)."""
    errs = []
    for i, (a, b) in enumerate(zip(out, ref)):
        e = (a - b).abs().max().item()
        errs.append(e / max(b.abs().max().item(), 1e-30) if i in (1, 2)
                    else e)
    return errs


def _post(url: str, payload: dict, timeout: float = 600.0,
          path: str = "/generate"):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


def _tokens(payload: dict, status: int, body: str):
    if payload.get("stream"):
        lines = [json.loads(x) for x in body.strip().splitlines()]
        check("done" in lines[-1], f"stream did not finish: {lines[-1]}")
        toks = [x["token"] for x in lines[:-1]]
        check(toks == lines[-1]["tokens"], "stream lines != its summary")
        return toks
    return json.loads(body)["tokens"][0]


def phase_serve(cfg: TransformerConfig, seed: int, dev):
    print("== serving: ServingEngine /generate ==")
    lm = TransformerLM(cfg, device=dev)
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(N_REQUESTS):
        n_prompt = int(rng.integers(64, 901))
        reqs.append({"tokens": [rng.integers(0, cfg.vocab_size, n_prompt)
                                .tolist()],
                     "n_new": int(rng.integers(32, 65)),
                     "temperature": 0.0 if i % 2 == 0 else 0.8,
                     "seed": int(seed * 1000 + i)})
    stream_req = dict(reqs[1], stream=True)
    widths = sorted({min(max(bucket_size(k), k), cfg.max_len) for k in (
        min(len(r["tokens"][0]), cfg.max_len - r["n_new"]) for r in reqs)})
    print(f"prompt lengths {sorted(len(r['tokens'][0]) for r in reqs)}; "
          f"admission prefill widths {widths}")
    eng = ServingEngine(lm, device=dev).start()
    d = eng.decoder
    print(f"decoder: {d.lanes} lanes, {d.n_blocks} blocks of "
          f"{d.block_tokens} tokens, table width {d.table_width}")
    try:
        # warm-up: one short request per admission width, so the timed
        # burst does not pay first-call costs (CUDA module loads, GEMM
        # heuristics) for its shapes
        first = {}
        for r in reqs:
            k = min(len(r["tokens"][0]), cfg.max_len - r["n_new"])
            first.setdefault(min(max(bucket_size(k), k), cfg.max_len), r)
        for r in first.values():
            _post(eng.url, dict(r, n_new=2, temperature=0.0))
        zero_counts()  # counts from the timed burst on
        ticks0, tick_s0 = d.decode_ticks, d.tick_seconds
        adm0, adm_s0 = d.admissions, d.admit_seconds
        dtok0 = d.dispatch_stats.decode_tokens
        toks, wall = burst(eng, reqs + [stream_req])
        ticks = d.decode_ticks - ticks0
        tick_ms = (d.tick_seconds - tick_s0) / max(ticks, 1) * 1e3
        per_dispatch = (d.dispatch_stats.decode_tokens - dtok0) \
            / max(ticks, 1)
        adm = d.admissions - adm0
        adm_ms = (d.admit_seconds - adm_s0) / max(adm, 1) * 1e3
        generated = sum(len(t) for t in toks)
        print(f"{len(toks)} requests answered (HTTP 200, right token "
              f"counts) in {wall:.3f} s: {generated} tokens, "
              f"{generated / wall:.1f} tokens/s, {ticks} decode ticks "
              f"({tick_ms:.3f} ms host wall each, {per_dispatch:.2f} "
              f"tokens a tick), {adm} admissions "
              f"({adm_ms:.3f} ms each), peak {d.peak_active} active lanes")
        _, body = _post(eng.url, reqs[1])
        check(_tokens(reqs[1], 200, body) == toks[-1],
              "streamed tokens != the same request without streaming")
        print("stream == non-stream (temperature 0.8): ok")
        _, body = _post(eng.url, reqs[0])
        check(_tokens(reqs[0], 200, body) == toks[0],
              "greedy request alone != the same request co-scheduled")
        _, body = _post(eng.url, reqs[3])
        check(_tokens(reqs[3], 200, body) == toks[3],
              "sampled request alone != the same request co-scheduled")
        print("solo == co-scheduled (greedy and temperature 0.8): ok")
        counts = counts_now()
        print(f"launches during serving: {counts}")
        check(counts["flash_attention"] > 0 and
              counts["paged_attention"] > 0,
              "a kernel of the path was not launched while serving")
        check(counts["flash_attention_plain"] == 0 and
              counts["paged_attention_plain"] == 0,
              "a plain version ran while serving on the card")
    finally:
        eng.stop()
    return lm, widths, counts, {"requests": len(toks), "wall_s": wall,
                                "generated_tokens": generated,
                                "tokens_per_s": generated / wall,
                                "decode_ticks": ticks,
                                "tick_wall_ms": tick_ms,
                                "tokens_per_dispatch": per_dispatch,
                                "admissions": adm,
                                "admit_wall_ms": adm_ms}, (reqs, toks)


def phase_predict(seed: int, dev):
    print("== serving: ServingEngine /predict (char-RNN) ==")
    conf = char_rnn_conf(VOCAB, lstm_size=LSTM_H, num_layers=2, seed=seed)
    net = MultiLayerNetwork(conf, device=dev).init(input_shape=(1, VOCAB))
    print(f"char-RNN: vocab {VOCAB}, 2 GravesLSTM x {LSTM_H}, "
          f"{net.num_params()} parameters")
    rng = np.random.default_rng(seed + 1)
    eye = np.eye(VOCAB, dtype=np.float32)
    reqs = [eye[rng.integers(0, VOCAB, (int(rng.integers(1, MAX_ROWS + 1)),
                                        SEQ))] for _ in range(N_PREDICT)]
    eng = ServingEngine(model=net, device=dev).start()
    try:
        t0 = time.perf_counter()
        warm = eng.registry.warmup(max_batch=eng.max_batch,
                                   sample_row=np.zeros((SEQ, VOCAB),
                                                       np.float32))
        print(f"warm-up over buckets {warm['buckets']}: "
              f"{time.perf_counter() - t0:.3f} s")
        for fn in (lstm_scan, lstm_scan_plain):  # counts from the burst on
            fn.launches = 0
        batch_rows = []  # N of every K1 call the layers make

        def recorded(xproj, *a, **kw):
            batch_rows.append(int(xproj.shape[0]))
            return lstm_scan(xproj, *a, **kw)

        s0 = eng.stats.snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recurrent.lstm_scan = recorded
        try:
            with ThreadPoolExecutor(N_CLIENTS) as ex:
                answers = list(ex.map(lambda x: _post(
                    eng.url, {"batch": x.tolist()}, path="/predict"), reqs))
        finally:
            recurrent.lstm_scan = lstm_scan
        wall = time.perf_counter() - t0
        counts = {fn.__name__: fn.launches
                  for fn in (lstm_scan, lstm_scan_plain)}
        rows_hist = {n: batch_rows.count(n) for n in sorted(set(batch_rows))}
        check(len(batch_rows) == counts["lstm_scan"],
              "a K1 launch of the burst was not recorded")
        s1 = eng.stats.snapshot()
        rows = sum(x.shape[0] for x in reqs)
        batches = s1["batches"] - s0["batches"]
        pad = s1["padded_rows"] - s0["padded_rows"]
        print(f"{len(answers)} requests, {rows} rows of T={SEQ} in "
              f"{wall:.3f} s: {rows / wall:.1f} rows/s, {batches} batches "
              f"({rows / max(batches, 1):.2f} real rows each, {pad} pad "
              f"rows), latency {s1['latency_ms']}")
        print(f"launches during the burst: {counts}; K1 launches by batch "
              f"rows N: {rows_hist}")
        check(counts["lstm_scan"] > 0,
              "K1 was not launched while serving /predict")
        check(counts["lstm_scan_plain"] == 0,
              "the plain LSTM scan ran while serving on the card")
        err = 0.0
        for x, (status, body) in zip(reqs, answers):
            check(status == 200, f"HTTP {status}: {body[:200]}")
            got = np.asarray(json.loads(body)["outputs"], np.float32)
            check(got.shape == (x.shape[0], SEQ, VOCAB)
                  and np.isfinite(got).all()
                  and np.abs(got.sum(-1) - 1).max() < 1e-4,
                  f"/predict answer of shape {got.shape} is not a row of "
                  "probabilities per step")
            alone = net.output(x).cpu().numpy()
            err = max(err, float(np.abs(got - alone).max()))
        print(f"every answer HTTP 200, finite, sums to 1; max |answer - "
              f"output(rows alone)| {err:.3e} (tol {TOL_PREDICT})")
        check(err <= TOL_PREDICT,
              "a batched /predict answer disagrees with direct output()")
        chars = [chr(32 + i) for i in range(VOCAB)]
        prime = "".join(c for c in "The " if c in chars)
        t0 = time.perf_counter()
        text = CharRnn(chars=chars, net=net).sample(
            prime, length=200, temperature=0.8, seed=seed)
        sample_s = time.perf_counter() - t0
        check(len(text) == len(prime) + 200 and text.startswith(prime)
              and set(text) <= set(chars),
              "CharRnn.sample gave a malformed string")
        print(f"CharRnn.sample: 200 characters through rnn_time_step in "
              f"{sample_s:.3f} s ({200 / sample_s:.1f} chars/s)")
    finally:
        eng.stop()
    return net, counts, {"requests": len(answers), "rows": rows,
                         "wall_s": wall, "rows_per_s": rows / wall,
                         "batches": batches, "pad_rows": pad,
                         "k1_launches_by_rows": rows_hist,
                         "latency_ms": s1["latency_ms"],
                         "max_abs_err_vs_direct": err,
                         "sample_chars_per_s": 200 / sample_s}


def profile_ms(fn, n: int = 5):
    """Device time per call of each CUDA kernel ``fn`` launches (sorted,
    from torch.profiler) and their sum, the device-busy time per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.device_time_total / n / 1e3, e.count // n, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.device_time_total > 0), reverse=True)
    return sum(r[0] for r in rows), rows


def launches_in_one_call(fn, name: str, tries: int = 3) -> int:
    """The CUDA kernels whose name holds ``name`` that one call of ``fn``
    launches, as torch.profiler records them: the most over ``tries``
    sessions of one call each (a dropped record can only lower a
    session's count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = 0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        best = max(best, sum(1 for e in prof.events()
                             if e.device_type == DeviceType.CUDA
                             and name in e.name))
    return best


def device_ms(fn, iters: int = 20, warmup: int = 3,
              sleep_cycles: int = 100_000_000) -> float:
    """Device time of one call: ``iters`` calls queued behind a sleep
    kernel (``sleep_cycles``: ~50 ms by default, far longer than the host
    needs to launch a kernel's calls), timed with CUDA events around
    them. Back-to-back events (:func:`time_ms`)
    also count the host's time per launch where it exceeds a short
    kernel's own (K4 at T <= 1024); torch.profiler's kernel sums proved
    short of records on the card (half of case a's launches missing in
    one run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)  # clock cycles
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def phase_times(lm: TransformerLM, widths, seed: int, dev):
    print("== times (CUDA events; K4, K6 and SDPA queued behind a sleep "
          "kernel, and back to back) ==")
    cfg = lm.cfg
    res = {"flash_attention": {}, "paged_attention": {}, "main_path": {}}
    for t in FLASH_WIDTHS:
        q, k, v = flash_inputs(t, seed, dev)
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        kern = lambda: flash_attention(q, k, v, causal=True)
        sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                      is_causal=True)
        ms, lib = device_ms(kern), device_ms(sdpa)
        ev, lib_ev = time_ms(kern), time_ms(sdpa)
        plain = time_ms(lambda: flash_attention_plain(q, k, v, causal=True),
                        iters=5)
        nbytes = 4 * t * H * HD * 2 + H * t * 4
        flops = 2.0 * HD * t * (t + 1) * H
        b_ms, b_by = bound(nbytes, flops)
        res["flash_attention"][t] = dict(ms=ms, plain_ms=plain,
                                         library_ms=lib, bound_ms=b_ms,
                                         bound_by=b_by, events_ms=ev,
                                         library_events_ms=lib_ev)
        print(f"flash_attention T={t}: {ms:.4f} ms on the device "
              f"({ev:.4f} back to back), plain {plain:.4f} ms, sdpa "
              f"{lib:.4f} ms ({lib_ev:.4f}), bound {b_ms:.4f} ms ({b_by})")
    for skewed in (True, False):  # the smoke's mix last: the tick's
        q, ck, cv, tables, pos = paged_inputs(seed + 1, dev, skewed=skewed)
        kern = lambda: paged_attention(q, ck, cv, tables, pos)
        ms, ev = device_ms(kern), time_ms(kern)
        plain = time_ms(lambda: paged_attention_plain(q, ck, cv, tables,
                                                      pos), iters=5)
        vis = float((pos.long() + 1).sum().item())
        nbytes = vis * H * HD * 2 * 2 + LANES * H * HD * (2 + 4) \
            + tables.numel() * 4 + LANES * 4
        flops = 4.0 * vis * H * HD
        b_ms, b_by = bound(nbytes, flops)
        r = dict(ms=ms, events_ms=ev, plain_ms=plain, library_ms=None,
                 bound_ms=b_ms, bound_by=b_by, mean_context=vis / LANES,
                 gb_per_s=nbytes / ms / 1e6, bound_share=b_ms / ms)
        if skewed:
            res["paged_attention"]["one_long_lane"] = r
        else:
            res["paged_attention"].update(r)
        print(f"paged_attention S={LANES} mean context {vis / LANES:.1f}"
              f"{' (one lane at 1024, 63 at 16)' if skewed else ''}: "
              f"{ms:.4f} ms on the device ({ev:.4f} back to back), "
              f"{nbytes / ms / 1e6:.1f} GB/s, bound {b_ms:.4f} ms ({b_by}; "
              f"{b_ms / ms:.1%} of the time), plain {plain:.4f} ms")
    # the f32-query instantiation at the smoke's mix: the bf16 row's
    # bytes, with q read in f32
    q32 = q.float()
    kern = lambda: paged_attention(q32, ck, cv, tables, pos)
    ms, ev = device_ms(kern), time_ms(kern)
    plain = time_ms(lambda: paged_attention_plain(q32, ck, cv, tables, pos),
                    iters=5)
    nbytes = vis * H * HD * 2 * 2 + LANES * H * HD * (4 + 4) \
        + tables.numel() * 4 + LANES * 4
    b_ms, b_by = bound(nbytes, 4.0 * vis * H * HD)
    res["paged_attention_f32q"] = dict(
        ms=ms, events_ms=ev, plain_ms=plain, library_ms=None, bound_ms=b_ms,
        bound_by=b_by, mean_context=vis / LANES, gb_per_s=nbytes / ms / 1e6,
        bound_share=b_ms / ms)
    print(f"paged_attention f32 q over a bf16 arena, S={LANES} mean context "
          f"{vis / LANES:.1f}: {ms:.4f} ms on the device ({ev:.4f} back to "
          f"back), bound {b_ms:.4f} ms ({b_by}; {b_ms / ms:.1%}), plain "
          f"{plain:.4f} ms")
    with torch.inference_mode():
        for w in widths:
            toks = torch.randint(0, cfg.vocab_size, (1, w), device=dev)
            p_ms = time_ms(lambda: prefill_cache(lm.compute_params, toks,
                                                 cfg), iters=5)
            res["main_path"][f"prefill_ms_w{w}"] = p_ms
            print(f"prefill width {w}: {p_ms:.3f} ms")
        n_blocks = 4096
        shape = (cfg.n_layers, n_blocks + 1, BT, cfg.n_heads,
                 cfg.d_model // cfg.n_heads)
        arena = {"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                 "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}
        tok = torch.randint(0, cfg.vocab_size, (LANES,), device=dev,
                            dtype=torch.int32)
        temps = [0.0] * LANES
        gens = [None] * LANES

        def tick():
            _, logits = paged_decode_step(lm.compute_params, arena, tok,
                                          pos, tables, cfg)
            return _sample_step(logits, temps, gens)

        t_ms = time_ms(tick, iters=10)
        res["main_path"]["decode_tick_ms_64_lanes"] = t_ms
        print(f"decode tick, {LANES} lanes, mean context "
              f"{vis / LANES:.1f}: {t_ms:.3f} ms")
        busy, rows = profile_ms(tick)
        res["main_path"]["tick_profile"] = dict(
            device_busy_ms=busy,
            kernels=[dict(ms=r[0], calls=r[1], name=r[2][:120])
                     for r in rows[:12]])
        print(f"decode tick profile: {busy:.3f} ms of kernels per tick "
              f"({busy / t_ms:.1%} of the {t_ms:.3f} ms tick)")
        for ms_, calls, name in rows[:12]:
            print(f"  {ms_:8.4f} ms  x{calls:<3d} {name[:100]}")
        toks = torch.randint(0, cfg.vocab_size, (1, max(widths)),
                             device=dev)
        busy, rows = profile_ms(
            lambda: prefill_cache(lm.compute_params, toks, cfg))
        p_ms = res["main_path"][f"prefill_ms_w{max(widths)}"]
        res["main_path"]["prefill_profile"] = dict(
            width=max(widths), device_busy_ms=busy,
            kernels=[dict(ms=r[0], calls=r[1], name=r[2][:120])
                     for r in rows[:12]])
        print(f"prefill width {max(widths)} profile: {busy:.3f} ms of "
              f"kernels ({busy / p_ms:.1%} of the {p_ms:.3f} ms "
              "prefill)")
        for ms_, calls, name in rows[:8]:
            print(f"  {ms_:8.4f} ms  x{calls:<3d} {name[:100]}")
    return res


def burst(eng, reqs, clients: int = N_CLIENTS):
    """The requests through HTTP ``/generate`` from ``clients`` threads:
    (transcripts, wall s); every answer HTTP 200 with its token count."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as ex:
        answers = list(ex.map(lambda p: (p, *_post(eng.url, p)), reqs))
    wall = time.perf_counter() - t0
    toks = []
    for p, status, body in answers:
        check(status == 200, f"HTTP {status}: {body[:200]}")
        t = _tokens(p, status, body)
        check(len(t) == p["n_new"], f"{len(t)} tokens for n_new {p['n_new']}")
        toks.append(t)
    return toks, wall


def zero_counts():
    for fn in KERNELS:
        fn.launches = 0


def counts_now():
    return {fn.__name__: fn.launches for fn in KERNELS}


def agreement(got, want):
    """(transcripts equal, shortest common prefix, mean common prefix)."""
    pre = []
    for a, b in zip(got, want):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        pre.append(n)
    equal = sum(1 for a, b in zip(got, want) if a == b)
    return equal, min(pre), float(np.mean(pre))


def phase_decode_planes(lm: TransformerLM, burst_run, seed: int, dev):
    """The decode planes of ``/generate`` on the bench transformer, at
    the serve phase's 64 lanes and 16-token blocks, against its burst:
    (a) k-step ticks, (b) speculative decode with both self-drafts, (c)
    the fixed-slot pool, (d) the bf16 arena under an f32 copy of the
    model, (e) the prefill/decode handoff."""
    print("== decode planes: k-step ticks, speculation, fixed slots, KV "
          "dtype, handoff ==")
    cfg = lm.cfg
    reqs, base = burst_run
    base = base[:len(reqs)]
    greedy = [i for i, r in enumerate(reqs) if r["temperature"] == 0.0]
    L = cfg.n_layers
    out = {}

    # (a) k-step ticks: the serve burst (its streamed request too) at
    # k = 1, 4, 4, 1 in turns, every answer byte-equal to the serve
    # phase's
    stream_req = dict(reqs[1], stream=True)
    runs = {1: [], 4: []}
    for kk in (1, 4, 4, 1):
        with env_set(DL4J_TPU_SERVE_TICK_K=str(kk)):
            eng = ServingEngine(lm, device=dev).start()
        d = eng.decoder
        try:
            check(d.tick_k == kk, f"DL4J_TPU_SERVE_TICK_K={kk} was not read")
            zero_counts()
            toks, wall = burst(eng, reqs + [stream_req])
            counts = counts_now()
            snap = d.dispatch_stats.snapshot()
        finally:
            eng.stop()
        check(toks == burst_run[1], f"a k={kk} answer differs from the "
              "serve burst's")
        check(counts["flash_attention"] > 0 and counts["paged_attention"] > 0
              and counts["flash_attention_plain"] == 0
              and counts["paged_attention_plain"] == 0,
              f"k={kk} ticks: kernels {counts}")
        gen = sum(len(t) for t in toks)
        runs[kk].append(dict(
            ticks=d.decode_ticks,
            tokens_per_dispatch=snap["tokens_per_dispatch"],
            tick_wall_ms=d.tick_seconds / max(d.decode_ticks, 1) * 1e3,
            tick_wall_s=d.tick_seconds, tokens_per_s=gen / wall,
            wall_s=wall, launches=counts))
    out["k_step"] = {f"k{kk}": r for kk, r in runs.items()}
    ticks = decode_device_times(lm, SPEC_K, seed, dev)
    out["k_step"]["tick_times"] = ticks
    for kk in (1, 4):
        r = runs[kk]
        print(f"(a) TICK_K={kk} (two bursts of {len(reqs) + 1}, in turns "
              f"1, 4, 4, 1): answers byte-equal to the serve burst's "
              f"(greedy and 0.8); ticks {[x['ticks'] for x in r]}, "
              f"tokens a tick {[x['tokens_per_dispatch'] for x in r]}, "
              f"host wall a tick "
              f"{[round(x['tick_wall_ms'], 3) for x in r]} ms, tick wall "
              f"in all {[round(x['tick_wall_s'] * 1e3, 1) for x in r]} ms,"
              f" tokens/s {[round(x['tokens_per_s'], 1) for x in r]}; "
              f"launches {r[0]['launches']}")
    print(f"(a) one 64-lane tick at mean context {ticks['mean_context']:.1f}"
          f": k=1 {ticks['tick1_ms']:.3f} ms on the device (kernels "
          f"{ticks['tick1_kernel_ms']:.3f}), {ticks['tick1_events_ms']:.3f} "
          f"back to back; k=4 {ticks['tick4_ms']:.3f} on the device "
          f"(kernels {ticks['tick4_kernel_ms']:.3f}), "
          f"{ticks['tick4_events_ms']:.3f} back to back")

    # (b) speculative decode: the greedy requests byte-equal to k = 1
    k = SPEC_K
    g_reqs = [reqs[i] for i in greedy]
    g_base = [base[i] for i in greedy]
    out["spec"] = {}
    for mode in ("int8", "layers:2"):
        with env_set(DL4J_TPU_SERVE_SPEC=mode, DL4J_TPU_SERVE_SPEC_K=str(k)):
            eng = ServingEngine(lm, device=dev).start()
        d = eng.decoder
        try:
            check(isinstance(d, SpeculativeDecoder) and d.spec_k == k,
                  f"DL4J_TPU_SERVE_SPEC={mode} built {type(d).__name__}")
            zero_counts()
            toks, wall = burst(eng, g_reqs)
            counts = counts_now()
            st = eng.stats.snapshot()
            snap = d.dispatch_stats.snapshot()
            rounds, base_ticks = d.spec_rounds, d.decode_ticks
            spec_s = d.spec_seconds
            draft = d._draft
            res = dict(rounds=rounds, base_ticks=base_ticks,
                       proposed=st["draft_proposed"],
                       accepted=st["draft_accepted"],
                       acceptance_rate=st["acceptance_rate"],
                       acceptance_note="random weights: a check of the "
                                       "mechanism, not a rate users see",
                       tokens_per_dispatch=snap["tokens_per_dispatch"],
                       round_wall_ms=spec_s / max(rounds, 1) * 1e3,
                       wall_per_token_ms=wall / sum(map(len, toks)) * 1e3,
                       tokens_per_s=sum(map(len, toks)) / wall,
                       launches=counts)
            check(toks == g_base, f"spec {mode}: a transcript differs from "
                  "the k=1 greedy burst's")
            want_k6 = L * ((k + 1) * rounds + base_ticks)
            check(rounds > 0 and counts["paged_attention"] == want_k6,
                  f"spec {mode}: {rounds} rounds, K6 launched "
                  f"{counts['paged_attention']} times, want L x ((k+1) x "
                  f"rounds + base ticks) = {want_k6}")
            check(counts["flash_attention"] > 0
                  and counts["flash_attention_plain"] == 0
                  and counts["paged_attention_plain"] == 0,
                  f"spec {mode}: kernels {counts}")
            if mode == "int8":
                # a mixed pool: while a sampled lane is active no round
                # runs, and every answer stays the k = 1 burst's
                s_i = next(i for i, r in enumerate(reqs)
                           if r["temperature"] > 0)
                first, at_end = threading.Event(), []
                fut = d.submit(reqs[s_i]["tokens"][0], reqs[s_i]["n_new"],
                               temperature=reqs[s_i]["temperature"],
                               seed=reqs[s_i]["seed"],
                               on_token=lambda t: first.set())
                check(first.wait(120), "the sampled request never started")
                r0 = d.spec_rounds
                fut.add_done_callback(lambda f: at_end.append(d.spec_rounds))
                gf = [d.submit(reqs[i]["tokens"][0], reqs[i]["n_new"],
                               temperature=0.0) for i in greedy[:3]]
                mixed = [f.result(timeout=300).tolist() for f in gf]
                check(fut.result(timeout=300).tolist() == base[s_i]
                      and mixed == [base[i] for i in greedy[:3]],
                      "the mixed pool's answers differ from the k=1 burst's")
                check(at_end and at_end[0] == r0,
                      "a speculative round ran while a sampled lane was "
                      "active")
                res["mixed_pool_rounds_while_sampled"] = at_end[0] - r0
        finally:
            eng.stop()
        if mode == "int8":
            # chaos: every proposal of rounds 0-2 rejected
            chaos = SpecChaos(SpecChaosConfig(reject_at_round=0, count=3))
            cd = SpeculativeDecoder(lm, draft=draft, spec_k=k,
                                    spec_chaos=chaos, n_blocks=1024,
                                    device=dev)
            try:
                fs = [cd.submit(reqs[i]["tokens"][0], reqs[i]["n_new"],
                                temperature=0.0) for i in greedy[:2]]
                got = [f.result(timeout=300).tolist() for f in fs]
            finally:
                cd.stop()
            check(got == [base[i] for i in greedy[:2]] and chaos.log
                  and cd.stats.draft_rejected > 0,
                  "an all-reject chaos round changed a transcript")
            res["chaos_rounds"] = len(chaos.log)
        # the round's device time at 64 lanes (CUDA events behind a sleep
        # kernel): the draft's k+1 dense steps, the target's verify
        res.update(decode_device_times(lm, k, seed, dev, draft=draft))
        out["spec"][mode] = res
        print(f"(b) SPEC={mode} k={k}: {len(toks)} greedy transcripts "
              f"byte-equal to k=1; {rounds} rounds + {base_ticks} base "
              f"ticks; proposed {res['proposed']}, accepted "
              f"{res['accepted']} ({res['acceptance_rate']}: random "
              f"weights); {res['tokens_per_dispatch']} tokens a dispatch; "
              f"round {res['round_wall_ms']:.3f} ms host wall, draft "
              f"{res['draft_ms']:.3f} + verify {res['verify_ms']:.3f} ms "
              f"on the device (kernels {res['draft_kernel_ms']:.3f} + "
              f"{res['verify_kernel_ms']:.3f}; {res['draft_events_ms']:.3f}"
              f" + {res['verify_events_ms']:.3f} back to back); "
              f"{res['wall_per_token_ms']:.3f} ms wall a "
              f"committed token, {res['tokens_per_s']:.1f} tokens/s; K6 "
              f"{counts['paged_attention']} = L x ((k+1) x rounds + "
              f"base ticks)"
              + (f"; chaos all-reject rounds {res['chaos_rounds']} exact; "
                 "mixed pool: no round while sampled"
                 if mode == "int8" else ""))

    # (c) the fixed-slot pool: 4 slots serve the 16 requests
    eng = ServingEngine(lm, kv_block=0, slots=4, device=dev).start()
    d = eng.decoder
    try:
        zero_counts()
        toks, wall = burst(eng, reqs)
        counts = counts_now()
        _, body = _post(eng.url, reqs[0])
        solo_g = _tokens(reqs[0], 200, body)
        _, body = _post(eng.url, reqs[3])
        solo_s = _tokens(reqs[3], 200, body)
    finally:
        eng.stop()
    check(solo_g == toks[0] and solo_s == toks[3],
          "fixed-slot: solo != co-scheduled")
    check(counts["flash_attention"] > 0
          and counts["flash_attention_plain"] == 0
          and counts["paged_attention_plain"] == 0,
          f"fixed-slot: kernels {counts}")
    eq, pmin, pmean = agreement([toks[i] for i in greedy], g_base)
    gen = sum(map(len, toks))
    out["fixed_slot"] = dict(slots=4, tokens_per_s=gen / wall, wall_s=wall,
                             ticks=d.decode_ticks, launches=counts,
                             greedy_equal_to_paged=eq,
                             greedy_common_prefix_min=pmin,
                             greedy_common_prefix_mean=pmean)
    print(f"(c) fixed-slot pool, 4 slots: {len(toks)} answers, "
          f"{gen / wall:.1f} tokens/s, {d.decode_ticks} ticks; solo == "
          f"co-scheduled; greedy transcripts equal to the paged pool's: "
          f"{eq}/{len(greedy)} (common prefix min {pmin}, mean "
          f"{pmean:.1f} tokens); launches {counts}")

    # (d) the arena's dtype: an f32 copy of the model (the same f32
    # master tensors), a bf16 arena against an f32 one on one budget
    cfg32 = dataclasses.replace(cfg, dtype_policy="strict")
    lm32 = TransformerLM(cfg32, device=dev, params=lm.params)
    budget = KV_BUDGET
    runs = {}
    for kv in ("bf16", "f32"):
        with env_set(DL4J_TPU_SERVE_KV_DTYPE=kv):
            nb = kv_arena_blocks(cfg32, BT, budget_bytes=budget,
                                 params=lm32.params)
            eng = ServingEngine(lm32, kv_blocks=nb, device=dev).start()
        try:
            cap = eng.decoder.kv_capacity()
            zero_counts()
            toks, wall = burst(eng, g_reqs)
            runs[kv] = dict(capacity=cap, toks=toks, wall=wall,
                            launches=counts_now())
        finally:
            eng.stop()
    del lm32
    c16, c32 = runs["bf16"]["capacity"], runs["f32"]["capacity"]
    ratio = c16["blocks_total"] / c32["blocks_total"]
    check(c16["kv_dtype"] == "bfloat16" and c32["kv_dtype"] == "float32"
          and 1.9 <= ratio <= 2.1,
          f"KV dtype arenas: {c16} against {c32}")
    k6_bf16 = runs["bf16"]["launches"]["paged_attention"]
    check(k6_bf16 > 0 and runs["bf16"]["launches"]["flash_attention"] > 0
          and all(runs[kv]["launches"][n] == 0 for kv in runs
                  for n in ("flash_attention_plain",
                            "paged_attention_plain")),
          f"KV dtype: kernels {runs['bf16']['launches']}")
    eq, pmin, pmean = agreement(runs["bf16"]["toks"], runs["f32"]["toks"])
    out["kv_dtype"] = dict(budget_bytes=budget,
                           blocks_bf16=c16["blocks_total"],
                           blocks_f32=c32["blocks_total"], ratio=ratio,
                           capacity_tokens_bf16=c16["capacity_tokens"],
                           capacity_tokens_f32=c32["capacity_tokens"],
                           k6_launches_bf16=k6_bf16,
                           transcripts_equal=eq, common_prefix_min=pmin,
                           common_prefix_mean=pmean,
                           tokens_per_s_bf16=sum(map(
                               len, runs["bf16"]["toks"]))
                           / runs["bf16"]["wall"],
                           tokens_per_s_f32=sum(map(
                               len, runs["f32"]["toks"]))
                           / runs["f32"]["wall"])
    print(f"(d) f32 model, {budget / 2**30:.0f} GiB budget: bf16 arena "
          f"{c16['blocks_total']} blocks ({c16['capacity_tokens']} tokens) "
          f"against f32 {c32['blocks_total']} ({ratio:.3f}x); K6 (f32 q, "
          f"bf16 arena) launched {k6_bf16} times; the two arenas' greedy "
          f"transcripts equal {eq}/{len(g_reqs)} (common prefix min "
          f"{pmin}, mean {pmean:.1f})")

    # (e) the handoff: a prefill-role engine and a decode-role engine on
    # the card, each with its own arena
    pre = ServingEngine(lm, kv_blocks=2048, device=dev).start()
    dec = ServingEngine(lm, kv_blocks=2048, device=dev).start()
    legs = []
    try:
        zero_counts()
        order = sorted(greedy, key=lambda i: len(reqs[i]["tokens"][0]))
        for i in (order[0], order[-1]):
            r = reqs[i]
            t0 = time.perf_counter()
            _, body = _post(pre.url, {"tokens": r["tokens"][0],
                                      "n_new": r["n_new"]}, path="/prefill")
            t_pre = time.perf_counter() - t0
            payload = json.loads(body)
            t0 = time.perf_counter()
            _, pbody = _post(dec.url, payload, path="/prime")
            t_prime = time.perf_counter() - t0
            adopted = json.loads(pbody)["adopted"]
            hits0 = dec.stats.prefix_hits
            t0 = time.perf_counter()
            _, gbody = _post(dec.url, r)
            t_gen = time.perf_counter() - t0
            hits = dec.stats.prefix_hits - hits0
            check(_tokens(r, 200, gbody) == base[i],
                  "a primed answer differs from the unprimed one")
            check(adopted == len(payload["digests"]) > 0 and hits == adopted,
                  f"handoff: {adopted} adopted of {len(payload['digests'])}"
                  f", {hits} prefix hits")
            legs.append(dict(prompt=len(r["tokens"][0]), blocks=adopted,
                             payload_bytes=len(body), prefill_s=t_pre,
                             prime_s=t_prime, generate_s=t_gen,
                             prefix_hits=hits))
        counts = counts_now()
    finally:
        pre.stop()
        dec.stop()
    check(counts["flash_attention"] > 0
          and counts["flash_attention_plain"] == 0
          and counts["paged_attention_plain"] == 0,
          f"handoff: kernels {counts}")
    out["handoff"] = dict(legs=legs, launches=counts)
    for leg in legs:
        print(f"(e) handoff, prompt {leg['prompt']} tokens: {leg['blocks']} "
              f"blocks, {leg['payload_bytes'] / 2**20:.1f} MiB of JSON; "
              f"/prefill {leg['prefill_s'] * 1e3:.1f} ms, /prime "
              f"{leg['prime_s'] * 1e3:.1f} ms, /generate "
              f"{leg['generate_s'] * 1e3:.1f} ms; primed == unprimed, "
              f"{leg['prefix_hits']} prefix hits == adopted")
    return out


def host_free_ms(fn, reps: int = 3):
    """(device ms, back-to-back ms, kernel ms) of one call of a
    launch-heavy ``fn``: one call queued behind a sleep kernel that
    outlasts its launches (three times its back-to-back time at up to
    2 GHz), the median of ``reps`` (one call at a time: the launches of
    several could fill the card's launch queue and put the host back on
    the clock); and the sum of its kernels' times from torch.profiler."""
    ev = time_ms(fn, iters=5, warmup=1)
    cycles = int(3 * ev * 2e6)
    dev_ms = float(np.median([device_ms(fn, iters=1, warmup=0,
                                        sleep_cycles=cycles)
                              for _ in range(reps)]))
    return dev_ms, ev, profile_ms(fn, n=3)[0]


def decode_device_times(lm: TransformerLM, k: int, seed: int, dev,
                        draft=None):
    """Device and back-to-back ms at 64 lanes over the smoke's context
    mix (capped k+1 below max_len): with ``draft``, one speculative
    round's draft (k+1 dense fixed-slot steps) and verify (k+1 paged
    steps); without, a greedy tick at k = 1 and at k = 4."""
    cfg = lm.cfg
    _, _, _, tables, pos = paged_inputs(seed + 2, dev)
    pos = torch.clamp(pos, max=cfg.max_len - k - 2)
    hd = cfg.d_model // cfg.n_heads
    zeros, nones = [0.0] * LANES, [None] * LANES
    res = dict(mean_context=float(pos.float().mean().item()) + 1)
    with torch.inference_mode():
        shape = (cfg.n_layers, 4097, BT, cfg.n_heads, hd)
        arena = {"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                 "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}
        tok = torch.randint(0, cfg.vocab_size, (LANES,), device=dev,
                            dtype=torch.int32)
        if draft is None:
            for kk in (1, 4):
                fn = lambda kk=kk: _paged_tick_for(cfg, kk)(
                    lm.compute_params, arena, tok, pos, tables, zeros,
                    nones)
                (res[f"tick{kk}_ms"], res[f"tick{kk}_events_ms"],
                 res[f"tick{kk}_kernel_ms"]) = host_free_ms(fn)
        else:
            dcfg = draft.cfg
            dshape = (dcfg.n_layers, LANES, dcfg.max_len, dcfg.n_heads, hd)
            cache = {n: torch.zeros(dshape, dtype=torch.bfloat16, device=dev)
                     for n in ("k", "v")}
            toks = torch.randint(0, cfg.vocab_size, (LANES, k + 1),
                                 device=dev)
            (res["draft_ms"], res["draft_events_ms"],
             res["draft_kernel_ms"]) = host_free_ms(
                lambda: _tick_for(dcfg, k + 1)(
                    draft.compute_params, cache, tok, pos, zeros, nones))
            (res["verify_ms"], res["verify_events_ms"],
             res["verify_kernel_ms"]) = host_free_ms(
                lambda: _verify_for(cfg, k)(
                    lm.compute_params, arena, toks, pos, tables))
            del cache
        del arena
    return res


def lstm_bound(n: int, t: int, h: int, emit_cs: bool = False):
    """Each input read once, each output written once, f32; 2*N*T*H*4H
    flops of h @ U at the 3xTF32 rate (the fastest f32-accurate products
    on this card)."""
    nbytes = 4.0 * (n * t * 4 * h + n * t * h + 4 * h * h + 3 * h
                    + 4 * n * h + (n * t * h if emit_cs else 0))
    return bound(nbytes, 2.0 * n * t * h * 4 * h, PEAK_F32_TC_FLOPS)


def phase_times_predict(net: MultiLayerNetwork, seed: int, dev):
    print("== times: K1 and the /predict path (CUDA events; K1 queued "
          "behind a sleep kernel, and back to back) ==")
    res = {"lstm_scan": {}, "main_path": {}}
    for n, t, h in LSTM_SHAPES:
        args = lstm_inputs(n, t, h, seed, dev)
        ms = device_ms(lambda: lstm_scan(*args), iters=10)
        ev = time_ms(lambda: lstm_scan(*args), iters=10)
        plain = time_ms(lambda: lstm_scan_plain(*args), iters=2, warmup=1)
        b_ms, b_by = lstm_bound(n, t, h)
        # the sequential floor: the per-step time of a one-row launch
        # (slope between T=8 and T=8+t), times T
        one = [lstm_inputs(1, tt, h, seed, dev) for tt in (8, 8 + t)]
        short, long_ = (device_ms(lambda a=a: lstm_scan(*a), iters=10)
                        for a in one)
        step_us = (long_ - short) / t * 1e3
        lstm = torch.nn.LSTM(h, h, batch_first=True).to(dev)
        xin = args[0][..., :h].contiguous()
        with torch.inference_mode():
            cudnn = time_ms(lambda: lstm(xin), iters=10)
        res["lstm_scan"][f"{n}x{t}x{h}"] = dict(
            ms=ms, events_ms=ev, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, step_floor_us=step_us,
            floor_ms=step_us * t / 1e3, cudnn_lstm_ms=cudnn)
        print(f"lstm_scan N={n} T={t} H={h}: {ms:.4f} ms on the device "
              f"({ev:.4f} back to back), plain "
              f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), sequential "
              f"floor {step_us * t / 1e3:.4f} ms ({step_us:.2f} us/step "
              f"at N=1); reference only (no peepholes): cuDNN nn.LSTM "
              f"{cudnn:.4f} ms")
    rng = np.random.default_rng(seed + 2)
    x = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (64, SEQ))]
    xt = torch.from_numpy(x).to(dev)
    o_ms = time_ms(lambda: net.output(xt), iters=10)
    res["main_path"]["output_ms_batch64"] = o_ms
    print(f"char-RNN output(), batch 64, T={SEQ}: {o_ms:.3f} ms")
    with torch.inference_mode():
        busy, rows = profile_ms(lambda: net.output(xt))
    res["main_path"]["output_profile"] = dict(
        device_busy_ms=busy,
        kernels=[dict(ms=r[0], calls=r[1], name=r[2][:120])
                 for r in rows[:8]])
    print(f"output() profile: {busy:.3f} ms of kernels per call "
          f"({busy / o_ms:.1%} of the {o_ms:.3f} ms call)")
    for ms_, calls, name in rows[:8]:
        print(f"  {ms_:8.4f} ms  x{calls:<3d} {name[:100]}")
    return res


def markov_text(seed: int, length: int, chars) -> str:
    """Text from a fixed random Markov chain over ``chars``: each character
    is followed by one of 4 successors with probabilities 0.55, 0.25,
    0.15 and 0.05 (1.11 nats of entropy per character, against ln 80 =
    4.38 for a model that has learnt nothing)."""
    rng = np.random.default_rng(seed)
    v = len(chars)
    succ = np.stack([rng.choice(v, 4, replace=False) for _ in range(v)])
    pick = np.searchsorted(np.cumsum([0.55, 0.25, 0.15, 0.05]),
                           rng.random(length) * 0.999999)
    out, c = [], 0
    for k in pick:
        c = succ[c, k]
        out.append(chars[c])
    return "".join(out)


def window_grads(net: MultiLayerNetwork, x, y):
    """The parameter gradients of one TBPTT window from zero state, as a
    train step computes them."""
    net._reset_rnn_states(x.shape[0])
    leaves = [{k: v.detach().requires_grad_() for k, v in p.items()}
              for p in net.params]
    loss, _ = net._loss(leaves, net.states, x, y, train=True,
                        step=net.iteration, carry_state=True)
    flat = [v for p in leaves for v in p.values()]
    names = [f"{i}.{k}" for i, p in enumerate(leaves) for k in p]
    return names, torch.autograd.grad(loss, flat)


class _PlainScan:
    """Stands in for LstmScanFn: autograd through K1's plain version."""

    @staticmethod
    def apply(*args):
        return lstm_scan_plain(*args)[:3]


def phase_train(seed: int, dev):
    print("== training: the char-RNN with TBPTT and RMSProp ==")
    conf = char_rnn_conf(VOCAB, lstm_size=LSTM_H, num_layers=2, seed=seed,
                         tbptt_length=TBPTT, learning_rate=TRAIN_LR)
    net = MultiLayerNetwork(conf, device=dev).init(input_shape=(1, VOCAB))
    print(f"char-RNN: vocab {VOCAB}, 2 GravesLSTM x {LSTM_H}, TBPTT {TBPTT}, "
          f"RMSProp lr {TRAIN_LR}, {net.num_params()} parameters")
    chars = [chr(32 + i) for i in range(VOCAB)]
    text = markov_text(seed, TRAIN_BATCH * SEQ * N_FITS + 1, chars)
    cr = CharRnn(chars=chars, net=net)
    col = CollectScoresIterationListener()
    net.set_listeners(col)
    kernels = (lstm_scan, lstm_scan_plain, lstm_scan_bwd,
               lstm_scan_bwd_plain)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # earlier phases' live tensors
    t0 = time.perf_counter()
    losses = cr.fit_text(text, batch=TRAIN_BATCH, seq_len=SEQ)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    counts = {fn.__name__: fn.launches for fn in kernels}
    net.set_listeners()
    windows = [s for _, s in col.scores]
    print(f"{len(losses)} fits of {TRAIN_BATCH}x{SEQ} one-hot characters "
          f"({len(windows)} TBPTT windows of {TBPTT}) in {wall:.3f} s: "
          f"{wall / len(losses) * 1e3:.2f} ms per fit, "
          f"{TRAIN_BATCH * SEQ * len(losses) / wall:.0f} characters/s "
          f"(first calls included); device memory at its peak "
          f"{peak / 2**20:.1f} MiB above what the earlier phases hold")
    print("loss per fit: " + " ".join(f"{v:.4f}" for v in losses))
    print(f"launches over the {len(losses)} fits: {counts}")
    check(len(losses) == N_FITS and len(windows) == 2 * N_FITS,
          f"{len(losses)} fits and {len(windows)} windows")
    check(all(np.isfinite(windows)), "a training loss is not finite")
    check(np.mean(losses[-5:]) < losses[0],
          "the loss did not fall over the fits")
    check(counts["lstm_scan"] == counts["lstm_scan_bwd"] == 4 * N_FITS,
          "K1 and K2 did not launch 4 times per fit (2 windows x 2 layers)")
    check(counts["lstm_scan_plain"] == 0
          and counts["lstm_scan_bwd_plain"] == 0,
          "a plain LSTM scan ran while training on the card")

    x, y = (torch.from_numpy(a[:, :TBPTT]).to(dev)
            for a in next(cr.batches(text, TRAIN_BATCH, SEQ)))
    names, got = window_grads(net, x, y)
    saved, recurrent.LstmScanFn = recurrent.LstmScanFn, _PlainScan
    try:
        _, want = window_grads(net, x, y)
    finally:
        recurrent.LstmScanFn = saved
    grad_err = {n: ((a - b).abs().max()
                    / b.abs().max().clamp_min(1e-30)).item()
                for n, a, b in zip(names, got, want)}
    worst = max(grad_err, key=grad_err.get)
    print(f"one window's gradients, kernels vs autograd through the plain "
          f"scan: max error {grad_err[worst]:.3e} of the largest entry "
          f"(leaf {worst}; tol {TOL_GRAD})")
    check(grad_err[worst] <= TOL_GRAD,
          "the kernels' gradients disagree with the plain scan's")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "char_rnn.zip")
        write_model(net, path)
        loaded = MultiLayerNetwork.load(path, device=dev)
    xs = torch.from_numpy(np.eye(VOCAB, dtype=np.float32)[
        np.random.default_rng(seed + 3).integers(0, VOCAB, (8, SEQ))]).to(dev)
    same = torch.equal(net.output(xs), loaded.output(xs))
    print(f"write_model -> MultiLayerNetwork.load: iteration "
          f"{loaded.iteration}, output bit-equal: {same}")
    check(same and loaded.iteration == net.iteration,
          "the saved and loaded net differs from the trained one")
    return net, {"fits": len(losses), "wall_s": wall,
                    "loss_per_fit": losses, "window_losses": windows,
                    "launches": counts, "grad_max_err": grad_err[worst],
                    "fits_memory_bytes": peak}


def phase_times_train(net: MultiLayerNetwork, seed: int, dev):
    print("== times: K2, K1 with cs, and fit (CUDA events; K1 and K2 "
          "queued behind a sleep kernel, and back to back) ==")
    res = {"lstm_scan_bwd": {}, "main_path": {}}
    for n, t, h in BWD_SHAPES:
        args = lstm_bwd_inputs(n, t, h, seed, dev)
        ms = device_ms(lambda: lstm_scan_bwd(*args), iters=10)
        ev = time_ms(lambda: lstm_scan_bwd(*args), iters=10)
        plain = time_ms(lambda: lstm_scan_bwd_plain(*args), iters=2,
                        warmup=1)
        b_ms, b_by = lstm_bwd_bound(n, t, h)
        one = [lstm_bwd_inputs(1, tt, h, seed, dev) for tt in (8, 8 + t)]
        short, long_ = (device_ms(lambda a=a: lstm_scan_bwd(*a), iters=10)
                        for a in one)
        step_us = (long_ - short) / t * 1e3
        res["lstm_scan_bwd"][f"{n}x{t}x{h}"] = dict(
            ms=ms, events_ms=ev, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, step_floor_us=step_us,
            floor_ms=step_us * t / 1e3)
        print(f"lstm_scan_bwd N={n} T={t} H={h}: {ms:.4f} ms on the device "
              f"({ev:.4f} back to back), plain "
              f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), sequential "
              f"floor {step_us * t / 1e3:.4f} ms ({step_us:.2f} us/step at "
              "N=1)")
    n, t, h = BWD_SHAPES[0]
    args = lstm_inputs(n, t, h, seed, dev)
    ms = device_ms(lambda: lstm_scan(*args, emit_cs=True), iters=10)
    ev = time_ms(lambda: lstm_scan(*args, emit_cs=True), iters=10)
    b_ms, b_by = lstm_bound(n, t, h, emit_cs=True)
    res["lstm_scan_cs"] = dict(ms=ms, events_ms=ev, bound_ms=b_ms,
                               bound_by=b_by, shape=f"{n}x{t}x{h}")
    print(f"lstm_scan N={n} T={t} H={h} emit_cs=True: {ms:.4f} ms on the "
          f"device ({ev:.4f} back to back), bound {b_ms:.4f} ms ({b_by})")
    rng = np.random.default_rng(seed + 4)
    eye = np.eye(VOCAB, dtype=np.float32)
    ids = rng.integers(0, VOCAB, (TRAIN_BATCH, SEQ + 1))
    x, y = (torch.from_numpy(eye[ids[:, sl]]).to(dev)
            for sl in (slice(0, SEQ), slice(1, SEQ + 1)))
    net.fit(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        net.fit(x, y)
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) / 10 * 1e3
    res["main_path"]["fit_ms"] = fit_ms
    res["main_path"]["train_chars_per_s"] = TRAIN_BATCH * SEQ / fit_ms * 1e3
    print(f"fit (batch {TRAIN_BATCH}, T={SEQ}, 2 windows): {fit_ms:.3f} ms "
          f"per call, {TRAIN_BATCH * SEQ / fit_ms * 1e3:.0f} training "
          "characters/s")
    busy, rows = profile_ms(lambda: net.fit(x, y))
    groups = {"K1 lstm_fwd_cluster": 0.0, "K2 lstm_bwd_*": 0.0,
              "GEMMs": 0.0, "updater (foreach)": 0.0, "other kernels": 0.0}
    for ms_, _, name in rows:
        low = name.lower()
        key = ("K2 lstm_bwd_*" if "lstm_bwd_" in name
               else "K1 lstm_fwd_cluster" if "lstm_fwd_cluster" in name
               else "GEMMs" if "gemm" in low or "xmma" in low
               or "nvjet" in low
               else "updater (foreach)" if "foreach" in low
               or "multi_tensor" in low
               else "other kernels")
        groups[key] += ms_
    groups["host gaps (wall - kernels)"] = fit_ms - busy
    res["main_path"]["fit_profile"] = dict(
        device_busy_ms=busy, groups=groups,
        kernels=[dict(ms=r[0], calls=r[1], name=r[2][:120])
                 for r in rows[:12]])
    print(f"fit profile: {busy:.3f} ms of kernels per call ({busy / fit_ms:.1%}"
          f" of the {fit_ms:.3f} ms call): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in groups.items()))
    for ms_, calls, name in rows[:12]:
        print(f"  {ms_:8.4f} ms  x{calls:<3d} {name[:100]}")
    return res


def lstm_bwd_bound(n: int, t: int, h: int):
    """Each input (xproj, U, p, h0, c0, cs, hs, dhs, dh_T, dc_T) read
    once, each output (dxproj, dU, dp, dh0, dc0) written once, f32;
    3 * 2*N*T*H*4H flops (the gate recompute, dz U^T and dU) at the
    3xTF32 rate."""
    nbytes = 4.0 * (2 * n * t * 4 * h + 3 * n * t * h + 2 * 4 * h * h
                    + 6 * h + 6 * n * h)
    return bound(nbytes, 3 * 2.0 * n * t * h * 4 * h, PEAK_F32_TC_FLOPS)


def sgns_inputs(v: int, d: int, b: int, k1: int, seed: int, dev,
                scale: float = 0.1, dead: bool = False):
    """f32 tables of N(0, scale^2) entries and a batch of uniform rows:
    label 1 in column 0; with ``dead``, 30 % dead negatives and every
    7th pair fully dead."""
    g = torch.Generator(device=dev).manual_seed(seed + v + d + b)
    syn0 = torch.randn((v, d), generator=g, device=dev) * scale
    syn1neg = torch.randn((v, d), generator=g, device=dev) * scale
    cx = torch.randint(0, v, (b,), generator=g, device=dev)
    tgt = torch.randint(0, v, (b, k1), generator=g, device=dev)
    labels = torch.zeros((b, k1), device=dev)
    labels[:, 0] = 1.0
    live = torch.ones((b, k1), device=dev)
    if dead:
        live = (torch.rand((b, k1), generator=g, device=dev) > 0.3).float()
        live[::7] = 0.0
    return syn0, syn1neg, cx, tgt, labels, live


def plain_step_f64(syn0, syn1neg, cx, tgt, labels, live, alpha):
    """The plain SGNS step on f64 copies of the same inputs, rounded into
    the tables once: the reference K3 is held to. The plain step in f32
    on the card adds with atomics straight onto the tables
    (``index_add_``): each add rounds at the size of the row's entries,
    which at ~190 hits per row drifts by more than TOL_SGNS of the
    update."""
    p0, p1 = syn0.double(), syn1neg.double()
    sgns_step_plain(p0, p1, cx, tgt, labels.double(), live.double(), alpha)
    syn0.copy_(p0)
    syn1neg.copy_(p1)
    return p0, p1


def sgns_errors(syn0, syn1neg, cx, tgt, labels, live, alpha=0.025):
    """K3 on copies of the tables against the plain step in f64 on the
    same inputs: per table, max |kernel - plain| over the largest entry
    of the plain update, and whether every row no live pair touches kept
    its bits under K3."""
    k0, k1 = syn0.clone(), syn1neg.clone()
    sgns_step(k0, k1, cx, tgt, labels, live, alpha)
    p0, p1 = plain_step_f64(syn0.clone(), syn1neg.clone(), cx, tgt, labels,
                            live, alpha)
    torch.cuda.synchronize()
    touched = (torch.zeros(len(syn0), dtype=torch.bool, device=syn0.device)
               .index_fill_(0, cx[live.sum(1) > 0], True),
               torch.zeros(len(syn1neg), dtype=torch.bool,
                           device=syn0.device)
               .index_fill_(0, tgt[live > 0], True))
    errs, kept = [], True
    for got, want, old, hit in ((k0, p0, syn0, touched[0]),
                                (k1, p1, syn1neg, touched[1])):
        upd = (want - old.double()).abs().max().item()
        errs.append((got.double() - want).abs().max().item()
                    / max(upd, 1e-30))
        kept &= torch.equal(got[~hit], old[~hit])
    return errs, kept, (k0, k1)


def sgns_bound(syn0, syn1neg, cx, tgt, labels, live):
    """The bound of one SGNS step on these inputs: each distinct row that a
    live pair touches read once and written once (f32), the indices, labels
    and liveness read once; 6*D flops (dot, neu1e, the syn1neg update) per
    live (pair, k) entry at the f32 rate. Also the per-entry count (a read
    and a write for every (pair, k) entry, collisions counted each time)
    and the distinct rows of each table."""
    d = syn0.shape[1]
    b, k1 = tgt.shape
    n0 = torch.unique(cx[live.sum(1) > 0]).numel()
    n1 = torch.unique(tgt[live > 0]).numel()
    flops = 6.0 * d * live.count_nonzero().item()
    inputs = 8.0 * (b + b * k1) + 4.0 * 2 * b * k1
    per_entry = bound(4.0 * (2 * b * d + 2 * b * k1 * d) + inputs, flops,
                      PEAK_F32_FLOPS)[0]
    return bound(4.0 * 2 * d * (n0 + n1) + inputs, flops,
                 PEAK_F32_FLOPS) + (per_entry, n0, n1)


def hottest_rows(cx, tgt, live):
    """(most hits on one syn0 row, on one syn1neg row, rows of more than
    WARP_HITS hits: those a CTA of K3 sums) of a batch, from hit_lists."""
    lists = hit_lists(cx, tgt, live)
    n = [torch.diff(starts) for _, starts, _ in lists]
    return (int(n[0].max()), int(n[1].max()),
            int(sum((x > WARP_HITS).sum().item() for x in n)))


def phase_kernels_sgns(seed: int, dev):
    print("== K3 (SGNS step) against its plain version ==")
    v, d, b, k1 = SGNS_SHAPES[0]
    cases = [("smoke model", SGNS_SHAPES[0], {}),
             ("hot class", SGNS_SHAPES[1], {}),
             ("V=64, ~190 hits per row", (64, 128, 2048, 6), {}),
             ("dots past +-MAX_EXP", SGNS_SHAPES[0], {"scale": 3.0}),
             ("dead negatives and pairs", SGNS_SHAPES[0], {"dead": True})]
    worst = 0.0
    for name, (v, d, b, k1), kw in cases:
        args = sgns_inputs(v, d, b, k1, seed, dev, **kw)
        errs, kept, first = sgns_errors(*args)
        again = sgns_errors(*args)[2]
        same = all(torch.equal(x, y) for x, y in zip(again, first))
        dots = torch.einsum("bd,bkd->bk", args[0][args[2]], args[1][args[3]])
        sat = (dots.abs() > 6.0).float().mean().item()
        hot0, hot1, n_cta = hottest_rows(args[2], args[3], args[5])
        print(f"sgns_step {name} (V={v} D={d} B={b} K+1={k1}): "
              f"max err / max update syn0 {errs[0]:.3e}, syn1neg "
              f"{errs[1]:.3e} (tol {TOL_SGNS}); untouched rows bit-equal: "
              f"{kept}; two launches bit-equal: {same}; |dot| > 6 for "
              f"{sat:.1%} of the entries; hottest rows {hot0} (syn0) and "
              f"{hot1} (syn1neg) hits, {n_cta} rows of more than {WARP_HITS}")
        check(max(errs) <= TOL_SGNS,
              f"sgns_step disagrees with its plain version ({name})")
        check(same, f"two sgns_step launches differ ({name})")
        check(kept, f"sgns_step moved a row no live pair touches ({name})")
        if "scale" in kw:
            check(sat > 0.1, "the saturation case saturates nothing")
        worst = max(worst, *errs)
    return {"sgns_step": {"max_err": worst}}


def topic_corpus(seed: int):
    """A seeded corpus of W2V_SENTENCES sentences of W2V_SENT words over
    W2V_VOCAB words ``w<i>`` planted in W2V_TOPICS topics (word i in topic
    i % W2V_TOPICS). A sentence belongs to one topic: W2V_MIN_COUNT
    copies of every word of the topic are spread over its sentences (so
    each word occurs at least that often), and the other slots draw from
    the topic's Zipf distribution over its words, or with probability
    W2V_NOISE from a global Zipf distribution over all words."""
    rng = np.random.default_rng(seed)
    names = np.array([f"w{i}" for i in range(W2V_VOCAB)], dtype=object)
    cdf = lambda n: np.cumsum(1.0 / np.arange(1, n + 1)) / \
        np.sum(1.0 / np.arange(1, n + 1))
    glob_word = rng.permutation(W2V_VOCAB)     # the word of global rank r
    glob_cdf = cdf(W2V_VOCAB)
    per_topic = W2V_SENTENCES // W2V_TOPICS
    sentences = []
    for t in range(W2V_TOPICS):
        members = np.arange(t, W2V_VOCAB, W2V_TOPICS)
        cover = rng.permutation(np.repeat(members, W2V_MIN_COUNT))
        parts = np.array_split(cover, per_topic)
        n_free = per_topic * W2V_SENT - len(cover)
        topical = members[np.minimum(np.searchsorted(
            cdf(len(members)), rng.random(n_free)), len(members) - 1)]
        noise = glob_word[np.minimum(np.searchsorted(
            glob_cdf, rng.random(n_free)), W2V_VOCAB - 1)]
        free = np.where(rng.random(n_free) < W2V_NOISE, noise, topical)
        start = 0
        for part in parts:
            n = W2V_SENT - len(part)
            sent = rng.permutation(np.concatenate([part,
                                                   free[start:start + n]]))
            start += n
            sentences.append(names[sent].tolist())
    order = rng.permutation(len(sentences))
    return [sentences[i] for i in order]


def topic_agreement(model) -> float:
    """The share of the W2V_TOP_N nearest neighbours (``words_nearest``)
    of the W2V_QUERY_WORDS most frequent words that share their topic
    (chance: 1 / W2V_TOPICS)."""
    same = 0
    for i in range(W2V_QUERY_WORDS):
        w = model.vocab.word_at_index(i)
        t = int(w[1:]) % W2V_TOPICS
        same += sum(int(x[1:]) % W2V_TOPICS == t
                    for x in model.words_nearest(w, W2V_TOP_N))
    return same / (W2V_QUERY_WORDS * W2V_TOP_N)


def ns_margin(model: Word2Vec, chunk) -> float:
    """Mean sigmoid(syn0[context] . syn1neg[center]) over the chunk's
    skip-gram pairs less the mean over the same contexts and the chunk's
    negatives (those that are not the center). Only negative sampling
    writes syn1neg, so the margin is 0 if K3 wrote nothing and below 0 if
    it pushed the wrong way."""
    lt = model.lookup_table
    dev = chunk["table"].device
    syn0, syn1neg = (torch.from_numpy(a).to(dev) for a in (lt.syn0,
                                                            lt.syn1neg))
    l1 = syn0[chunk["cxs"]]                                # [NB, B, D]
    pos = torch.sigmoid((l1 * syn1neg[chunk["cens"]]).sum(-1))
    neg = torch.sigmoid(torch.einsum("nbd,nbkd->nbk", l1,
                                     syn1neg[chunk["draws"]]))
    keep = chunk["draws"] != chunk["cens"][..., None]
    return (pos.mean() - neg[keep].mean()).item()


def w2v_model(seed: int, dev) -> Word2Vec:
    return Word2Vec(layer_size=W2V_D, window=W2V_WINDOW, negative=W2V_NEG,
                    batch_size=W2V_BATCH, epochs=1,
                    min_word_frequency=W2V_MIN_COUNT, seed=seed, device=dev)


def w2v_rehearsal(seed: int = 0):
    """The smoke's word2vec fit on the CPU (plain SGNS step), printing its
    topic agreement and negative-sampling margin: the sources of
    W2V_AGREEMENT_CPU and W2V_NS_MARGIN_CPU. Run as
    ``python3 -c "import chip_smoke; chip_smoke.w2v_rehearsal()"``."""
    corpus = topic_corpus(seed)
    model = w2v_model(seed, "cpu")
    t0 = time.perf_counter()
    model.fit_tokens(corpus)
    agreement = topic_agreement(model)
    # the smoke's chunk, then two chunks of other pairs and draws
    margins = [ns_margin(model, w2v_chunk(model, corpus, s, "cpu"))
               for s in (seed, seed + 1, seed + 2)]
    print(f"CPU rehearsal, seed {seed}: vocab {model.vocab_size()}, "
          f"{model.fit_stats}, {time.perf_counter() - t0:.1f} s; topic "
          f"agreement {agreement!r}; negative-sampling margins {margins!r}")
    return agreement, margins[0]


def w2v_chunk(model: Word2Vec, corpus, seed: int, dev, n_batches: int = 16):
    """The inputs of ``n_batches`` skip-gram batches of the trained model
    as ``skipgram_batches`` takes them, with fixed draws [NB, B, K] from
    the unigram table."""
    lt = model.lookup_table
    rng = np.random.default_rng(seed + 5)
    seqs = model._sequences_as_indices(corpus[:200])
    centers, contexts = model._make_pairs(seqs, rng)
    order = rng.permutation(len(centers))[:n_batches * W2V_BATCH]
    check(len(order) == n_batches * W2V_BATCH, "too few pairs for a chunk")
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    P, C, M = lt.huffman_tensors()
    table = up(lt.table.astype(np.int64))
    g = torch.Generator(device=dev).manual_seed(seed + 6)
    draws = table[torch.randint(0, len(table), (n_batches, W2V_BATCH,
                                                W2V_NEG), generator=g,
                                device=dev)]
    shape = (n_batches, W2V_BATCH)
    return {"huffman": (up(P.astype(np.int64)), up(C), up(M)),
            "cens": up(centers[order].astype(np.int64).reshape(shape)),
            "cxs": up(contexts[order].astype(np.int64).reshape(shape)),
            "plive": torch.ones(shape, device=dev),
            "alphas": torch.full((n_batches,), 0.0125, device=dev),
            "draws": draws, "table": table}


def chunk_tables(model: Word2Vec, dev):
    """Device copies of the model's syn0, syn1 and syn1neg."""
    lt = model.lookup_table
    return tuple(torch.tensor(a, device=dev)
                 for a in (lt.syn0, lt.syn1, lt.syn1neg))


def run_chunk(model: Word2Vec, chunk, ns_step, draw=None, tables=None):
    """The chunk's batches in an eager loop of ``skipgram_step`` on
    ``tables``, by default device copies of the model's."""
    if tables is None:
        tables = chunk_tables(model, chunk["table"].device)
    skipgram_batches(tables, chunk["huffman"], chunk["cens"], chunk["cxs"],
                     chunk["plive"], chunk["alphas"], negative=W2V_NEG,
                     draw=draw or replay_draw(chunk["draws"]),
                     ns_step=ns_step)
    return tables


def chunk_graph(model: Word2Vec, chunk, draw=None, tables=None):
    """The chunk's batches captured as one CUDA graph (the fit's path) on
    ``tables``; returns the tables and the runner, whose ``run`` replays
    the chunk again."""
    if tables is None:
        tables = chunk_tables(model, chunk["table"].device)
    runner = SkipgramGraphs(tables, chunk["huffman"], W2V_BATCH, W2V_NEG,
                            draw or replay_draw(chunk["draws"]))
    runner.run(chunk["cens"], chunk["cxs"], chunk["plive"], chunk["alphas"])
    return tables, runner


def phase_word2vec(seed: int, dev):
    print("== training: word2vec skip-gram, HS + negative sampling ==")
    t0 = time.perf_counter()
    corpus = topic_corpus(seed)
    corpus_s = time.perf_counter() - t0
    n_tokens = sum(len(s) for s in corpus)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    model = w2v_model(seed, dev)
    t0 = time.perf_counter()
    model.build_vocab(corpus)
    vocab_s = time.perf_counter() - t0
    depth = max(w.code_length for w in model.vocab.vocab_words())
    print(f"corpus: {len(corpus)} sentences, {n_tokens} tokens, "
          f"{W2V_TOPICS} topics ({corpus_s:.2f} s to make); vocabulary and "
          f"Huffman tree: {model.vocab_size()} words, depth up to {depth}, "
          f"{vocab_s:.3f} s of host time")
    check(model.vocab_size() == W2V_VOCAB,
          f"the vocabulary has {model.vocab_size()} words, not {W2V_VOCAB}")
    for fn in (sgns_step, sgns_step_plain):
        fn.launches = 0
    t0 = time.perf_counter()
    model.fit_tokens(corpus)
    fit_s = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in (sgns_step, sgns_step_plain)}
    peak = torch.cuda.max_memory_allocated() - held
    st = model.fit_stats
    pairs_per_s = st["examples"] / st["loop_s"]
    print(f"fit_tokens: {st['examples']} skip-gram pairs in {st['batches']} "
          f"batches of {W2V_BATCH}; pair assembly {st['assembly_s']:.3f} s "
          f"(host), device loop {st['loop_s']:.3f} s: {pairs_per_s:.0f} "
          f"pairs/s; whole fit {fit_s:.3f} s; device memory at its peak "
          f"{peak / 2**20:.1f} MiB above the earlier phases' tensors")
    print(f"launches over the fit: {counts}; CUDA graphs: "
          f"{st['graph_captures']} captured in {st['graph_capture_s']:.3f} s "
          f"(in the device loop), {st['graph_replays']} replays; "
          f"{st['examples'] / (st['loop_s'] - st['graph_capture_s']):.0f} "
          f"pairs/s after the captures")
    lt = model.lookup_table
    check(st["graph_replays"] > 0 and st["graph_captures"] > 0,
          "the fit's skip-gram chunks did not run as CUDA graph replays")
    check(all(np.isfinite(a).all() for a in (lt.syn0, lt.syn1, lt.syn1neg)),
          "a word2vec table is not finite")
    check(counts["sgns_step"] == st["batches"]
          and counts["sgns_step_plain"] == 0,
          "K3 did not run exactly once per negative-sampling batch")
    t0 = time.perf_counter()
    agreement = topic_agreement(model)
    print(f"topic agreement of the {W2V_TOP_N} nearest neighbours of the "
          f"{W2V_QUERY_WORDS} most frequent words: {agreement:.4f} (chance "
          f"{1 / W2V_TOPICS:.4f}, CPU rehearsal {W2V_AGREEMENT_CPU}; "
          f"{time.perf_counter() - t0:.1f} s)")
    check(agreement >= 10.0 / W2V_TOPICS,
          "the embeddings do not beat 10x chance on topic agreement")
    check(agreement >= W2V_AGREEMENT_CPU - 0.05,
          "topic agreement fell more than 0.05 below the CPU rehearsal's")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "w2v.zip")
        save_word2vec(model, path)
        loaded = load_word2vec(path, device=dev)
    same = all(np.array_equal(getattr(loaded.lookup_table, n), getattr(lt, n))
               for n in ("syn0", "syn1", "syn1neg"))
    print(f"save_word2vec -> load_word2vec: tables bit-equal: {same}")
    check(same, "the loaded word2vec differs from the saved one")
    chunk = w2v_chunk(model, corpus, seed, dev)
    margin = ns_margin(model, chunk)
    print(f"negative-sampling margin (sigmoid of the pairs' dots less the "
          f"negatives', over the chunk's {chunk['cens'].numel()} pairs): "
          f"{margin:.4f} (CPU rehearsal {W2V_NS_MARGIN_CPU})")
    check(margin >= W2V_NS_MARGIN_CPU / 2,
          "the negative-sampling margin is less than half the CPU "
          "rehearsal's: syn1neg did not learn the pairs")
    before = chunk_tables(model, dev)
    # the chunk three ways on copies of the same tables with the same
    # draws: replayed as a graph, eagerly, and through the plain step in
    # f64. Under torch.use_deterministic_algorithms the HS ops' index_add_
    # adds in a fixed order, so graph and eager can give the same bits and
    # K3 against the plain step differs by the NS step only
    det_error = None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            try:
                graph = chunk_graph(model, chunk)[0]
            except RuntimeError as e:  # reported; the graph is retried below
                det_error = f"{type(e).__name__}: {str(e)[:200]}"
            got = run_chunk(model, chunk, sgns_step)
            want = run_chunk(model, chunk, plain_step_f64)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    if det_error is not None:
        graph = chunk_graph(model, chunk)[0]
        torch.cuda.synchronize()
    rel = lambda xs, ys: [(a.double() - b.double()).abs().max().item()
                          / max((b.double() - o.double()).abs().max().item(),
                                1e-30) for a, b, o in zip(xs, ys, before)]
    chunk_err = rel(got, want)
    graph_err = rel(graph, got)
    graph_same = all(torch.equal(a, b) for a, b in zip(graph, got))
    print(f"16 batches through K3 vs the plain step (f64, rounded once) on "
          f"the card, same draws:"
          f" max err / max update syn0 {chunk_err[0]:.3e}, syn1 "
          f"{chunk_err[1]:.3e}, syn1neg {chunk_err[2]:.3e} (tol {TOL_SGNS})")
    print("the same 16 batches replayed as one CUDA graph vs the eager loop"
          + (" (both deterministic)" if det_error is None else
             f" (the graph not deterministic: its capture under "
             f"use_deterministic_algorithms raised {det_error})")
          + f": bit-equal {graph_same}; max diff / max update syn0 "
          f"{graph_err[0]:.3e}, syn1 {graph_err[1]:.3e}, syn1neg "
          f"{graph_err[2]:.3e}")
    check(max(chunk_err) <= TOL_SGNS,
          "a chunk through K3 disagrees with the same chunk through the "
          "plain step")
    if det_error is None:
        check(graph_same, "the replayed chunk differs from the eager loop "
              "under deterministic algorithms")
    check(max(graph_err) <= TOL_SGNS,
          "the replayed chunk disagrees with the eager loop")
    return model, chunk, {
        "tokens": n_tokens, "sentences": len(corpus),
        "vocab": model.vocab_size(), "huffman_depth": depth,
        "corpus_s": corpus_s, "vocab_huffman_s": vocab_s,
        "pair_assembly_s": st["assembly_s"], "device_loop_s": st["loop_s"],
        "pairs": st["examples"], "batches": st["batches"],
        "pairs_per_s": pairs_per_s, "fit_s": fit_s, "launches": counts,
        "topic_agreement": agreement, "ns_margin": margin,
        "chunk_max_err": max(chunk_err), "graph_vs_eager": dict(
            bit_equal=graph_same, max_err=max(graph_err),
            deterministic=det_error is None, capture_error=det_error),
        "graph_captures": st["graph_captures"],
        "graph_capture_s": st["graph_capture_s"],
        "graph_replays": st["graph_replays"],
        "pairs_per_s_after_capture":
            st["examples"] / (st["loop_s"] - st["graph_capture_s"]),
        "phase_memory_bytes": peak}


def chunk_profile(fn, wall: float):
    """The kernels of one call of ``fn`` (a 16-batch chunk) by group from
    torch.profiler, the host gaps beside ``wall`` ms, and K3's launches
    in the trace."""
    busy, rows = profile_ms(fn, n=2)
    groups = {"K3 sgns kernels": 0.0, "draws (randint)": 0.0,
              "HS and glue ops": 0.0}
    k3 = 0.0
    for ms_, calls, name in rows:
        key = ("K3 sgns kernels" if "sgns_" in name
               else "draws (randint)" if "distribution" in name
               or "random" in name.lower() or "philox" in name.lower()
               else "HS and glue ops")
        groups[key] += ms_
        k3 += calls if "sgns_" in name else 0
    groups["host gaps (wall - kernels)"] = wall - busy
    return busy, rows, groups, k3


def phase_times_word2vec(model: Word2Vec, chunk, seed: int, dev):
    print("== times: K3 and the word2vec batch loop (CUDA events) ==")
    res = {"sgns_step": {}, "main_path": {}}
    b = W2V_BATCH
    labels = torch.zeros((b, W2V_NEG + 1), device=dev)
    labels[:, 0] = 1.0
    cen, draws = chunk["cens"][0], chunk["draws"][0]
    real = (chunk["cxs"][0], torch.cat([cen[:, None], draws], dim=1), labels,
            torch.cat([torch.ones((b, 1), device=dev),
                       (draws != cen[:, None]).float()], dim=1))
    lt = model.lookup_table
    for v, d, bb, k1 in SGNS_SHAPES + ((64, W2V_D, b, W2V_NEG + 1),
                                       (SGNS_SHAPES[0][0], W2V_D, 1,
                                        W2V_NEG + 1)):
        if (v, d, bb) == SGNS_SHAPES[0][:3]:  # the fit's own batch
            syn0, syn1neg = (torch.from_numpy(a).to(dev)
                             for a in (lt.syn0, lt.syn1neg))
            args = (syn0, syn1neg) + real
        else:
            args = sgns_inputs(v, d, bb, k1, seed, dev)
        # device time: the calls queued behind a sleep kernel; back to
        # back: the wrapper's host time included; the profiler: each launch
        ms = device_ms(lambda: sgns_step(*args, 0.0125), iters=50)
        call = time_ms(lambda: sgns_step(*args, 0.0125), iters=50)
        busy, rows = profile_ms(lambda: sgns_step(*args, 0.0125), n=20)
        plain = time_ms(lambda: sgns_step_plain(*args, 0.0125), iters=10)
        b_ms, b_by, entry_ms, n0, n1 = sgns_bound(*args)
        hot0, hot1, n_cta = hottest_rows(*args[2:4], args[5])
        key = f"{v}x{d}x{bb}x{k1}"
        res["sgns_step"][key] = dict(
            ms=ms, events_ms=call, profiler_ms=busy,
            launches_per_call=len(rows), plain_ms=plain,
            bound_ms=b_ms, bound_by=b_by, bound_per_entry_ms=entry_ms,
            distinct_rows=[n0, n1], hottest_rows=[hot0, hot1],
            rows_over_slots=n_cta,
            launches=[dict(ms=r[0], name=r[2][:80]) for r in rows])
        print(f"sgns_step V={v} D={d} B={bb} K+1={k1}: {ms:.4f} ms of device "
              f"time per call, {len(rows)} launches ("
              + ", ".join(f"{short_name(r[2])} {r[0] * 1e3:.1f} us"
                          for r in rows)
              + f"), {call:.4f} ms per call back to back, plain "
              f"{plain:.4f} ms, bound {b_ms:.5f} ms ({b_by}; {n0} distinct "
              f"syn0 rows, {n1} syn1neg rows of this batch, the hottest "
              f"{hot0} and {hot1} hits, {n_cta} rows of more than "
              f"{WARP_HITS}; "
              f"counted per entry {entry_ms:.5f} ms)")
    n = chunk["cens"].shape[0]
    # the chunk eagerly (the fit's draws, from a generator) and replayed as
    # one graph (the generator registered with it), on copies of the tables
    loops = {}
    draw = unigram_draw(chunk["table"], W2V_NEG, b,
                        torch.Generator(device=dev).manual_seed(seed))
    tables = chunk_tables(model, dev)
    loops["eager"] = lambda: run_chunk(model, chunk, sgns_step, draw=draw,
                                       tables=tables)
    gdraw = unigram_draw(chunk["table"], W2V_NEG, b,
                         torch.Generator(device=dev).manual_seed(seed))
    gtables = chunk_tables(model, dev)
    t0 = time.perf_counter()
    runner = chunk_graph(model, chunk, draw=gdraw, tables=gtables)[1]
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    loops["graph"] = lambda: runner.run(chunk["cens"], chunk["cxs"],
                                        chunk["plive"], chunk["alphas"])
    for mode, loop in loops.items():
        loop()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            loop()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3 * 1e3
        before = sgns_step.launches
        busy, rows, groups, k3 = chunk_profile(loop, wall)
        counted = (sgns_step.launches - before) / 3
        res["main_path"][f"chunk16_{mode}"] = dict(
            wall_ms=wall, device_busy_ms=busy, groups=groups,
            pairs_per_s=n * b / wall * 1e3, k3_kernels_in_trace=k3,
            k3_launches_counted=counted,
            kernels=[dict(ms=r[0], calls=r[1], name=r[2][:120])
                     for r in rows[:16]])
        print(f"16 batches {mode} (on a copy of the tables, the fit's "
              f"draws): {wall:.3f} ms wall ({n * b / wall * 1e3:.0f} pairs/s)"
              f", {busy:.3f} ms of kernels ({busy / wall:.1%}): " + ", ".join(
                  f"{k} {v:.3f} ms" for k, v in groups.items())
              + f"; K3 kernels per chunk in the trace {k3:g}, K3 launches "
              f"counted {counted:g}")
        for ms_, calls, name in rows[:12]:
            print(f"  {ms_:8.4f} ms  x{calls:<3d} {name[:100]}")
        check(k3 == 2 * n and counted == n,
              f"the {mode} chunk's trace or counter does not show K3 once "
              f"per batch (two kernels a call)")
    res["main_path"]["chunk16_graph"]["capture_s"] = capture_s
    print(f"capturing the 16-batch graph (its first replay included): "
          f"{capture_s:.3f} s")
    return res


# ---------------------------------------------------------------------------
# slice 5: K5, the ring and the masked MultiHeadAttention network
# ---------------------------------------------------------------------------


def ext_inputs(n: int, tq: int, tk: int, h: int, d: int, seed: int, dev,
               dtype=torch.bfloat16, keep: float = 0.0):
    """q [n, tq, h, d], k, v [n, tk, h, d] of N(0, 1) entries in ``dtype``,
    and with ``keep`` > 0 a seeded [n, tk] key mask keeping that share."""
    g = torch.Generator(device=dev).manual_seed(seed + n + tq + tk + d)
    q = torch.randn((n, tq, h, d), generator=g, device=dev, dtype=dtype)
    k, v = (torch.randn((n, tk, h, d), generator=g, device=dev, dtype=dtype)
            for _ in range(2))
    km = None
    if keep:
        km = (torch.rand((n, tk), generator=g, device=dev) < keep).float()
    return q, k, v, km


def ext_errors(o, lse, ro, rlse):
    """(max |dO|, max |dlse| over the finite rows, whether the rows that
    must be -inf are exactly -inf with O exactly 0)."""
    fin = torch.isfinite(rlse)
    exact = bool(torch.equal(torch.isfinite(lse), fin)
                 and (lse[~fin] == float("-inf")).all()
                 and (o[(~fin).permute(0, 2, 1)] == 0).all())
    el = (lse[fin] - rlse[fin]).abs().max().item() if fin.any() else 0.0
    return (o.float() - ro.float()).abs().max().item(), el, exact


def check_ext(name, q, k, v, km, offset, tol_o, tol_lse):
    o, lse = flash_attention_block(q, k, v, offset=offset, key_mask=km)
    ro, rlse = flash_attention_block_plain(q, k, v, offset=offset,
                                           key_mask=km)
    torch.cuda.synchronize()
    eo, el, exact = ext_errors(o, lse, ro, rlse)
    dead = int((~torch.isfinite(rlse)).sum().item())
    print(f"flash_attention_block {name}: max|dO| {eo:.3e} (tol {tol_o}), "
          f"max|dlse| {el:.3e} (tol {tol_lse}); {dead} rows with no "
          f"visible key exactly O = 0, lse = -inf: {exact}")
    check(eo <= tol_o and el <= tol_lse and exact,
          f"flash_attention_block disagrees with its plain version ({name})")
    return eo, el


def k5_one_p(q, k, v):
    """K5 at offset 0 with no bias, from the variant library built with
    one bf16 P in P.V (``ONE_P``): read and timed beside the shipped
    kernel, called through no wrapper (so no launch counter), on no
    path."""
    lib = build.load("flash_attention", flash_mod.SIGNATURES, ONE_P)
    (n, h, d), strides = flash_mod._check_inputs("one-P K5", q, k, v,
                                                 same_t=False)
    tq, tk = q.shape[1], k.shape[1]
    o = torch.empty((n, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, h, tq), dtype=torch.float32, device=q.device)
    rc = lib.flash_attention_ext_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(),
        lse.data_ptr(), n, tq, tk, h, d, *strides, 0, 1, q.device.index,
        flash_mod._stream(q.device))
    build.check(lib, rc, "flash_attention_block (one bf16 P)")
    return o, lse


def sdpa_causal(q, k, v):
    """``scaled_dot_product_attention``, causal, of [N, T, H, D] tensors."""
    return F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in (q, k, v)),
        is_causal=True).transpose(1, 2)


def check_causal(name, q, k, v):
    """Causal bf16 with no bias, where K4 computes K5's function at offset
    0: K4 against its plain version at the bars and bit-equal to K5; the
    one-P variant and SDPA read against the same plain version."""
    ro, rlse = flash_attention_plain(q, k, v, causal=True)
    o4, lse4 = flash_attention(q, k, v, causal=True)
    o5, lse5 = flash_attention_block(q, k, v, offset=0)
    o1, lse1 = k5_one_p(q, k, v)
    o_sdpa = sdpa_causal(q, k, v)
    torch.cuda.synchronize()
    err = lambda a, b: (a.float() - b.float()).abs().max().item()
    res = dict(k4_o=err(o4, ro), k4_lse=err(lse4, rlse),
               k4_equals_k5=bool(torch.equal(o4, o5)
                                 and torch.equal(lse4, lse5)),
               one_p_o=err(o1, ro), one_p_lse=err(lse1, rlse),
               sdpa_o=err(o_sdpa, ro), max_abs_o=ro.float().abs().max().item())
    print(f"flash_attention {name}: max|dO| {res['k4_o']:.3e} (tol "
          f"{TOL_FLASH_O}), max|dlse| {res['k4_lse']:.3e} (tol "
          f"{TOL_FLASH_LSE}); bit-equal to K5 at offset 0: "
          f"{res['k4_equals_k5']}. Against the same plain version (max|O| "
          f"{res['max_abs_o']:.3f}): one-P variant max|dO| "
          f"{res['one_p_o']:.3e}, max|dlse| {res['one_p_lse']:.3e}; sdpa "
          f"max|dO| {res['sdpa_o']:.3e}")
    check(res["k4_o"] <= TOL_FLASH_O and res["k4_lse"] <= TOL_FLASH_LSE,
          f"flash_attention disagrees with its plain version ({name})")
    check(res["k4_equals_k5"], f"K4 and K5 at offset 0 differ ({name})")
    return res


def four_shard_ring(q, k, v, km, causal: bool, p: int = RING_SHARDS):
    """Every (my, src) step a p-rank ring takes, in one process: the
    shards in a list, ``ring_flash_step`` per step, combined per rank."""
    tl = q.shape[1] // p
    sh = lambda a, r: None if a is None else a[:, r * tl:(r + 1) * tl]
    outs = []
    for my in range(p):
        st = ring_flash_init(sh(q, my))
        for step in range(p):
            src = (my - step) % p
            st = ring_flash_step(st, sh(q, my), sh(k, src), sh(v, src),
                                 sh(km, src), my=my, src=src, t_local=tl,
                                 n_dev=p, causal=causal)
        outs.append(ring_flash_finish(st, q.dtype))
    return torch.cat(outs, dim=1)


def phase_kernels_ext(seed: int, dev):
    print("== K5 (flash attention with a key bias and an offset) against "
          "its plain version ==")
    bf, f32 = torch.bfloat16, torch.float32
    err_o = err_lse = 0.0

    def run(name, args, offset, tol_o, tol_lse):
        nonlocal err_o, err_lse
        eo, el = check_ext(name, *args, offset, tol_o, tol_lse)
        err_o, err_lse = max(err_o, eo), max(err_lse, el)

    witnesses = {}  # K4, the one-P variant and SDPA at cases a and g
    n, t, h, d = EXT_RING
    name = f"a: ring-local N={n} T={t} H={h} D={d} bf16 off=0"
    run(name, ext_inputs(n, t, t, h, d, seed, dev), 0, TOL_FLASH_O,
        TOL_FLASH_LSE)
    witnesses["a"] = check_causal(name,
                                  *ext_inputs(n, t, t, h, d, seed, dev)[:3])
    n, t, h, d = EXT_MASKED
    run(f"b: masked N={n} T={t} H={h} D={d} bf16 causal, keep {EXT_KEEP}",
        ext_inputs(n, t, t, h, d, seed, dev, keep=EXT_KEEP), 0,
        TOL_FLASH_O, TOL_FLASH_LSE)
    for off in (1024, 512, -512, -1024):
        run(f"c: T=1024 H=8 D=64 bf16 off={off}",
            ext_inputs(2, 1024, 1024, 8, 64, seed + off, dev), off,
            TOL_FLASH_O, TOL_FLASH_LSE)
    q, k, v, km = ext_inputs(2, 1024, 1024, 8, 64, seed, dev)
    o, lse = flash_attention_block(q, k, v, offset=-1024)
    torch.cuda.synchronize()
    check(bool((o == 0).all()) and bool((lse == float("-inf")).all()),
          "off = -1024 did not give O exactly 0 and lse exactly -inf")
    for off in (0, 320, -100):
        run(f"d: ragged Tq=192 Tk=320 H=8 D=64 bf16 masked off={off}",
            ext_inputs(2, 192, 320, 8, 64, seed + off, dev, keep=0.7), off,
            TOL_FLASH_O, TOL_FLASH_LSE)
    q, k, v, km = ext_inputs(3, 512, 512, 8, 64, seed, dev, keep=0.8)
    km[1] = 0.0
    run("e: batch row 1 with every key masked, T=512 bf16 off=512",
        (q, k, v, km), 512, TOL_FLASH_O, TOL_FLASH_LSE)
    for dd in (32, 64, 128):
        run(f"f: f32 D={dd} T=640 H=4 masked off=0",
            ext_inputs(2, 640, 640, 4, dd, seed, dev, f32, keep=0.8), 0,
            TOL_EXT_F32, TOL_EXT_F32)
    # the shapes the main path gives K5: one ring step per layer of the
    # bench transformer (world 1, offset 0), and each MHA layer of the
    # masked fit (not causal: offset T; the fit's own length mask)
    # (g is also K4's shape in Ulysses and in `forward`)
    n, t, h, d = ring_shape(seed)
    name = f"g: ring path N={n} T={t} H={h} D={d} bf16 off=0"
    run(name, ext_inputs(n, t, t, h, d, seed + 7, dev), 0, TOL_FLASH_O,
        TOL_FLASH_LSE)
    witnesses["g"] = check_causal(name, *ext_inputs(n, t, t, h, d, seed + 7,
                                                 dev)[:3])
    q, k, v, _ = ext_inputs(MHA_N, MHA_T, MHA_T, MHA_HEADS,
                            MHA_W // MHA_HEADS, seed, dev, f32)
    run(f"h: MHA fit N={MHA_N} T={MHA_T} H={MHA_HEADS} "
        f"D={MHA_W // MHA_HEADS} f32, lengths 64-{MHA_T}, off={MHA_T}",
        (q, k, v, mha_batch(seed, dev)[2]), MHA_T, TOL_EXT_F32, TOL_EXT_F32)
    # the in-process 4-shard ring: K5 at the offsets a 4-rank ring uses
    err_ring = 0.0
    for causal in (True, False):
        for keep in (0.0, 0.8):
            q, k, v, km = ext_inputs(2, 4 * 512, 4 * 512, 8, 64, seed + 5,
                                     dev, keep=keep)
            got = four_shard_ring(q, k, v, km, causal)
            want = flash_attention_block_plain(
                q, k, v, offset=0 if causal else q.shape[1],
                key_mask=km)[0]
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            print(f"{RING_SHARDS}-shard ring in one process, T=2048 H=8 "
                  f"D=64 bf16, causal={causal}, mask={bool(keep)}: max|dO| "
                  f"{e:.3e} (tol {TOL_FLASH_O})")
            check(e <= TOL_FLASH_O, "the in-process ring disagrees with the "
                  "plain full attention")
            err_ring = max(err_ring, e)
    return {"flash_attention_block": {"max_abs_err": err_o,
                                      "max_abs_err_lse": err_lse,
                                      "max_abs_err_ring": err_ring,
                                      "causal_cases": witnesses}}


def ext_bound(q, km, offset: int, tensors: int = 4, flops: float = 4.0):
    """The bound of an attention pass on these inputs: ``tensors`` [N, T,
    H, D] tensors moved once (K5: q, k, v read, O written; K7: q, k, v, O,
    dO read, dq, dk, dv written: 8), lse and the mask once; ``flops``·D
    flops per visible (query, key) pair per head, counted on this mask
    (K5: q·k and p·v, 4; K7: five products, 10), at the fastest rate this
    card reaches for q's type at its accuracy: bf16 tensor cores, and for
    f32 3xTF32 on the tensor cores."""
    n, t, h, d = q.shape
    qi = torch.arange(t, device=q.device)
    vis = (qi[:, None] + offset >= qi[None, :]).float()      # [T, T]
    keep = torch.ones((n, t), device=q.device) if km is None else km
    pairs = float((vis.sum(0)[None] * keep).sum().item()) * h
    nbytes = tensors * n * t * h * d * q.element_size() + 4.0 * n * h * t \
        + (4.0 * n * t if km is not None else 0.0)
    peak = PEAK_F32_TC_FLOPS if q.dtype == torch.float32 \
        else PEAK_BF16_FLOPS
    return bound(nbytes, flops * d * pairs, peak) + (pairs,)


def phase_times_ext(seed: int, dev):
    print("== times: K5, its plain version and scaled_dot_product_attention "
          "(CUDA events; queued behind a sleep kernel, and back to back) ==")
    res = {"flash_attention_block": {}}
    torch.backends.cuda.matmul.allow_tf32 = False  # strict f32 (case h)
    # a, b: bf16 causal (the ring-local and masked shapes); g: bf16
    # causal, the ring phase's own shape (K4's too, in Ulysses); h: f32,
    # the masked MHA fit's layer (not causal: offset T, the fit's length
    # mask). At a and g the one-P variant is timed beside the kernel.
    mha_shape = (MHA_N, MHA_T, MHA_HEADS, MHA_W // MHA_HEADS)
    for case, (n, t, h, d), keep, dtype in (
            ("a", EXT_RING, 0.0, torch.bfloat16),
            ("b", EXT_MASKED, EXT_KEEP, torch.bfloat16),
            ("g", ring_shape(seed), 0.0, torch.bfloat16),
            ("h", mha_shape, None, torch.float32)):
        q, k, v, km = ext_inputs(n, t, t, h, d, seed, dev, dtype=dtype,
                                 keep=keep or 0.0)
        causal = keep is not None
        if not causal:
            km = mha_batch(seed, dev)[2]
        off = 0 if causal else t
        kern = lambda: flash_attention_block(q, k, v, offset=off,
                                             key_mask=km)
        ms, ev = device_ms(kern), time_ms(kern, iters=10)
        plain = time_ms(lambda: flash_attention_block_plain(
            q, k, v, offset=off, key_mask=km), iters=3, warmup=1)
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        if km is None:
            sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                          is_causal=True)
        else:
            allowed = (km > 0)[:, None, None, :]
            if causal:
                allowed = allowed & torch.ones(
                    (t, t), dtype=torch.bool, device=dev).tril()[None, None]
            sdpa = lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=allowed)
        lib, lib_ev = device_ms(sdpa), time_ms(sdpa, iters=10)
        one_p = device_ms(lambda: k5_one_p(q, k, v)) if case in "ag" \
            else None
        b_ms, b_by, pairs = ext_bound(q, km, off)
        kind = "bf16 causal" if causal else "f32, the fit's length mask"
        res["flash_attention_block"][case] = dict(
            shape=f"N={n} T={t} H={h} D={d} {kind}"
                  + (f", keep {keep}" if keep else ""),
            ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
            bound_by=b_by, gflop=4.0 * d * pairs / 1e9, events_ms=ev,
            library_events_ms=lib_ev, one_p_ms=one_p)
        print(f"flash_attention_block {case} (N={n} T={t} H={h} D={d} "
              f"{kind}): {ms:.4f} ms on the device ({ev:.4f} back to back), "
              f"plain {plain:.4f} ms, sdpa {lib:.4f} ms ({lib_ev:.4f}), "
              f"bound {b_ms:.4f} ms ({b_by}; {4.0 * d * pairs / 1e9:.2f}"
              f" GFLOP of visible pairs), {4.0 * d * pairs / ms / 1e9:.1f} "
              "TFLOP/s" + ("" if one_p is None else
                           f"; one-P variant {one_p:.4f} ms"))
    return res


def ring_shape(seed: int):
    """(N, T, H, D) of the attention in the ring phase's transformer."""
    rc = ring_cfg(seed)
    return 1, RING_T, rc.n_heads, rc.d_model // rc.n_heads


def ring_cfg(seed: int, **kw) -> TransformerConfig:
    """The bench transformer of ``bench.py:356-370`` at the long-context
    length of ``bench.py:522``."""
    base = dict(vocab_size=8192, d_model=2048, n_layers=4, n_heads=32,
                d_ff=8192, max_len=RING_T, dtype_policy="performance",
                use_flash=True, seed=seed)
    base.update(kw)
    return TransformerConfig(**base)


def phase_ring(seed: int, dev, group):
    print("== ring: TransformerLM ring_forward on a world-1 NCCL group ==")
    import torch.distributed as dist

    cfg = ring_cfg(seed)
    lm = TransformerLM(cfg, device=dev)
    n_params = sum(v.numel() for v in [lm.params[k] for k in (
        "embed", "pos")] + list(lm.params["blocks"].values()))
    print(f"bench transformer: d_model {cfg.d_model}, {cfg.n_layers} "
          f"layers, {cfg.n_heads} heads of {cfg.d_model // cfg.n_heads}"
          f", d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, bf16, "
          f"{n_params / 1e6:.1f} M parameters; backend "
          f"{dist.get_backend(group)}, world {dist.get_world_size()}")
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    toks = torch.randint(0, cfg.vocab_size, (1, RING_T), generator=g,
                         device=dev)
    cp = lm.compute_params
    kernels = (flash_attention_block, flash_attention_block_plain,
               flash_attention, flash_attention_plain)
    with torch.inference_mode():
        for fn in kernels:
            fn.launches = 0
        ring = ring_forward(cp, toks, cfg, group)
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in kernels}
        ref = forward(cp, toks, cfg)[0]
        torch.cuda.synchronize()
        err = (ring - ref).abs().max().item()
        print(f"ring_forward N=1 T={RING_T}: logits {tuple(ring.shape)}, "
              f"finite {bool(torch.isfinite(ring).all())}; max |ring - "
              f"forward (K4)| {err:.3e} (tol {TOL_RING_BF16}; bit-equal "
              f"{err == 0.0}); launches {counts}")
        check(tuple(ring.shape) == (1, RING_T, cfg.vocab_size)
              and bool(torch.isfinite(ring).all()),
              "ring_forward gave logits of the wrong shape or not finite")
        check(err <= TOL_RING_BF16, "ring_forward disagrees with forward")
        check(counts["flash_attention_block"] == cfg.n_layers
              and counts["flash_attention_block_plain"] == 0
              and counts["flash_attention"] == 0,
              "ring_forward did not run K5 once per layer (and nothing "
              "else)")
        cfg32 = ring_cfg(seed, dtype_policy="strict")
        toks32 = toks[:, :RING_T_F32]
        r32 = ring_forward(lm.params, toks32, cfg32, group)
        f32 = forward(lm.params, toks32, cfg32)[0]
        torch.cuda.synchronize()
        err32 = (r32 - f32).abs().max().item()
        print(f"f32 strict at T={RING_T_F32}: max |ring - forward| "
              f"{err32:.3e} (tol {TOL_RING_F32})")
        check(err32 <= TOL_RING_F32,
              "ring_forward disagrees with forward in f32")
        ring_ms = time_ms(lambda: ring_forward(cp, toks, cfg, group),
                          iters=5, warmup=1)
        fwd_ms = time_ms(lambda: forward(cp, toks, cfg), iters=5,
                         warmup=1)
        for fn in kernels:
            fn.launches = 0
        uly = ring_forward(cp, toks, cfg, group, strategy="ulysses")
        torch.cuda.synchronize()
        uly_counts = {fn.__name__: fn.launches for fn in kernels}
        err_u = (uly - ref).abs().max().item()
        uly_ms = time_ms(lambda: ring_forward(cp, toks, cfg, group,
                                              strategy="ulysses"),
                         iters=5, warmup=1)
        busy, rows = profile_ms(lambda: ring_forward(cp, toks, cfg,
                                                     group), n=3)
    groups = {"K5 flash_fwd_tc": 0.0, "GEMMs": 0.0,
              "other kernels": 0.0}
    for ms_, _, name in rows:
        low = name.lower()
        key = ("K5 flash_fwd_tc" if "flash_fwd" in name
               else "GEMMs" if "gemm" in low or "xmma" in low
               or "nvjet" in low or "cutlass" in low
               else "other kernels")
        groups[key] += ms_
    groups["host gaps (wall - kernels)"] = ring_ms - busy
    tokens_per_s = RING_T / ring_ms * 1e3
    print(f"ring_forward: {ring_ms:.3f} ms per forward ({tokens_per_s:.0f}"
          f" tokens/s); forward through K4 {fwd_ms:.3f} ms; ulysses "
          f"(K4 over all T) {uly_ms:.3f} ms (max |ulysses - forward| "
          f"{err_u:.3e}; launches {uly_counts}); "
          f"kernels {busy:.3f} ms ({busy / ring_ms:.1%}): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in groups.items()))
    for ms_, calls, name in rows[:10]:
        print(f"  {ms_:8.4f} ms  x{calls:<3d} {name[:100]}")
    check(err_u <= TOL_RING_BF16, "ulysses disagrees with forward")
    check(uly_counts["flash_attention"] == cfg.n_layers
          and uly_counts["flash_attention_plain"] == 0
          and uly_counts["flash_attention_block"] == 0,
          "ulysses did not run K4 once per layer (and nothing else)")
    del lm
    return counts, {"tokens": RING_T, "max_abs_err_vs_forward": err,
                    "bit_equal_to_forward": err == 0.0,
                    "ulysses_launches": uly_counts,
                    "max_abs_err_f32": err32, "ring_ms": ring_ms,
                    "forward_k4_ms": fwd_ms, "ulysses_ms": uly_ms,
                    "ulysses_max_abs_err": err_u,
                    "tokens_per_s": tokens_per_s,
                    "profile": dict(device_busy_ms=busy, groups=groups,
                                    kernels=[dict(ms=r[0], calls=r[1],
                                                  name=r[2][:120])
                                             for r in rows[:12]])}


# ---------------------------------------------------------------------------
# slice 12: sequence-parallel training and K7 with an lse cotangent
# ---------------------------------------------------------------------------


def ring_batch(seed: int, dev, k=None):
    """Global tokens/targets [(K,) RT_N, RT_T] from the Markov stream."""
    shape = (RT_N, RT_T + 1) if k is None else (k, RT_N, RT_T + 1)
    ids = torch.from_numpy(markov_tokens(seed, shape, 8192)).to(dev)
    return ids[..., :-1], ids[..., 1:]


def leaf_errors(got: dict, want: dict) -> dict:
    """Each leaf's largest error, of its largest entry in ``want``."""
    return {k: ((got[k].float() - want[k].float()).abs().max()
                / want[k].float().abs().max().clamp_min(1e-30)).item()
            for k in want}


def lm_bar(name: str, attention_bar: float, rest_bar: float) -> float:
    """The card LM step test's bars: the attention weights at the dtype's
    bar, the other leaves at the bf16 rounding bar."""
    return attention_bar if name in ("blocks.Wq", "blocks.Wk", "blocks.Wv",
                                     "blocks.Wo") else rest_bar


def step_profile(fn, step_ms: float, fwd: str, adam_ms: float):
    """(device-busy ms, groups, rows) of one call of a training step."""
    busy, rows = profile_ms(fn, n=3)
    groups = {fwd: 0.0, "K7 flash_bwd": 0.0, "GEMMs": 0.0, "NCCL": 0.0,
              "other kernels": 0.0}
    for ms_, _, name in rows:
        key = ("NCCL" if "nccl" in name.lower()
               else kernel_group(name, fwd, "other kernels"))
        groups[key] += ms_
    groups["Adam (its kernels, profiled alone)"] = adam_ms
    groups["other kernels"] -= adam_ms
    groups["host gaps (wall - kernels)"] = step_ms - busy
    return busy, groups, rows


class plain_flash:
    """Within it, ``FlashBlockFn`` runs K5's and K7's plain versions on
    the card (the chain's reference); nothing else changes."""

    def __enter__(self):
        self.saved = (flash_mod.flash_attention_block, flash_mod.flash_bwd)
        flash_mod.flash_attention_block = flash_attention_block_plain
        flash_mod.flash_bwd = flash_block_bwd
        return self

    def __exit__(self, *exc):
        flash_mod.flash_attention_block, flash_mod.flash_bwd = self.saved
        return False


def ring_chain_grads(q, k, v, km, g, p: int = RING_SHARDS):
    """dq, dk, dv of the causal ``p``-shard ring driven in one process
    (``ring_flash_step`` for every (my, src), combined per rank through
    each block's lse, as :func:`four_shard_ring`) for the cotangent g."""
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    with torch.enable_grad():
        out = four_shard_ring(*leaves, km, causal=True, p=p)
        return torch.autograd.grad(out, leaves, g)


def dense_grads(q, k, v, km, g):
    """dq, dk, dv of the whole sequence's causal attention in one call:
    ``FlashFn`` (K4 + K7) without a mask, ``FlashBlockFn`` (K5 + K7) with
    one."""
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    with torch.enable_grad():
        if km is None:
            out = flash_mod.FlashFn.apply(*leaves, True)
        else:
            out = flash_mod.FlashBlockFn.apply(*leaves, km, 0)[0]
        return torch.autograd.grad(out, leaves, g)


def check_ring_backward(name: str, q, k, v, km, seed: int):
    """K7 under a real lse cotangent: the in-process ring's gradients
    through K5/K7 against the same chain through their plain versions and
    against the dense backward, each within 1e-2 of each gradient's
    largest entry; masked keys' dK and dV exactly 0; the lse cotangents
    K7 received, and its launches."""
    gen = torch.Generator(device=q.device).manual_seed(seed + 3)
    g = torch.randn(q.shape, generator=gen, device=q.device, dtype=q.dtype)
    seen = []
    real = flash_mod.flash_bwd

    def spy(*args):
        if args[-1] is not None:
            seen.append(args[-1].abs().max().item())
        return real(*args)

    spy.launches = 0  # K7's wrapper counts on the name it is called by
    for fn in (flash_attention_block, flash_block_bwd,
               flash_attention_block_plain):
        fn.launches = 0
    flash_mod.flash_bwd = spy
    try:
        got = ring_chain_grads(q, k, v, km, g)
    finally:
        flash_mod.flash_bwd = real
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in (
        flash_attention_block, flash_block_bwd, flash_attention_block_plain)}
    counts["flash_bwd"] = spy.launches
    with plain_flash():
        plain = ring_chain_grads(q, k, v, km, g)
    dense = dense_grads(q, k, v, km, g)
    torch.cuda.synchronize()
    e_plain, e_dense = bwd_error(got, plain), bwd_error(got, dense)
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    keys0 = km is None or all(bool((a[km == 0] == 0).all())
                              for a in got[1:])
    n_steps = RING_SHARDS * RING_SHARDS
    print(f"{RING_SHARDS}-shard ring backward in one process, {name}: max "
          f"error {e_plain:.3e} against the plain chain, {e_dense:.3e} "
          f"against the dense backward (of each gradient's largest entry, "
          f"tol {TOL_BWD_BF16}); finite {finite}; largest |g_lse| K7 "
          f"received {max(seen):.3e} over {len(seen)} calls; launches "
          f"{counts}" + ("" if km is None else
                         f"; masked keys' dK, dV exactly 0: {keys0}"))
    check(e_plain <= TOL_BWD_BF16 and e_dense <= TOL_BWD_BF16 and finite
          and keys0, f"the ring's backward through K7 disagrees ({name})")
    check(len(seen) == n_steps and max(seen) > 0,
          "K7 got no lse cotangent in the ring's backward")
    check(counts["flash_attention_block"] == n_steps
          and counts["flash_bwd"] == n_steps
          and counts["flash_block_bwd"] == 0
          and counts["flash_attention_block_plain"] == 0,
          "the ring's chain did not run K5 and K7 once per step")
    return {"max_err_vs_plain_chain": e_plain,
            "max_err_vs_dense": e_dense, "max_abs_g_lse": max(seen),
            "launches": counts}


def phase_ring_train(seed: int, dev, group):
    print("== ring training: the bench TransformerLM, sequence-parallel on "
          "the world-1 NCCL group ==")
    cfg = ring_cfg(seed, learning_rate=LM_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    lm = TransformerLM(cfg, device=dev, group=group)
    L = cfg.n_layers
    print(f"TransformerLM(cfg, group=...): d_model {cfg.d_model}, {L} "
          f"layers, {cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, max_len {cfg.max_len}, bf16 compute, f32 "
          f"masters, Adam lr {cfg.learning_rate}; global batch {RT_N} x "
          f"T={RT_T} ({RT_N * RT_T} tokens a step), {RT_FITS} fits, then "
          f"fit_batches of {RT_MULTI}; then {RT_ULYSSES} Ulysses steps")
    p0 = lm_mod.tree_map(torch.clone, lm.params)
    batches = [ring_batch(seed + i, dev) for i in range(RT_FITS)]
    xs, ys = ring_batch(seed + 100, dev, k=RT_MULTI)
    kernels = (flash_attention_block, flash_attention_block_plain,
               flash_attention, flash_attention_plain, flash_bwd,
               flash_block_bwd)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(lm.fit(x, y)) for x, y in batches]
    multi = [float(v) for v in lm.fit_batches(xs, ys)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in kernels}
    steps = RT_FITS + RT_MULTI
    print("ring loss per fit: " + " ".join(f"{v:.4f}" for v in losses)
          + "; fit_batches: " + " ".join(f"{v:.4f}" for v in multi)
          + f"; {steps} steps in {wall:.3f} s (first calls included); "
          f"launches {counts}")
    check(all(np.isfinite(losses + multi)), "a ring training loss is not "
          "finite")
    check(np.mean(multi) < losses[0] and multi[-1] < losses[0],
          "the ring training loss did not fall")
    check(lm.iteration == steps and int(lm.opt["t"]) == steps,
          "the iteration is not the step count")
    check(counts["flash_attention_block"] == counts["flash_bwd"] == L * steps
          and counts["flash_attention"] == 0
          and counts["flash_attention_plain"] == 0
          and counts["flash_attention_block_plain"] == 0
          and counts["flash_block_bwd"] == 0,
          "the ring step did not run K5 and K7 once per layer per step "
          "(and nothing else)")
    uly = lm_mod.make_ring_train_step(cfg, group, strategy="ulysses")
    up, uo = lm.params, lm.opt
    for fn in kernels:
        fn.launches = 0
    uly_losses = []
    for i in range(RT_ULYSSES):
        up, uo, loss = uly(up, uo, *ring_batch(seed + 200 + i, dev))
        uly_losses.append(float(loss))
    uly_counts = {fn.__name__: fn.launches for fn in kernels}
    print("ulysses loss per step: " + " ".join(f"{v:.4f}" for v in
                                               uly_losses)
          + f"; launches {uly_counts}")
    check(all(np.isfinite(uly_losses)) and max(uly_losses) < losses[0],
          "the Ulysses losses are not finite or not below the first")
    check(uly_counts["flash_attention"] == uly_counts["flash_bwd"]
          == L * RT_ULYSSES
          and uly_counts["flash_attention_block"] == 0
          and uly_counts["flash_attention_plain"] == 0
          and uly_counts["flash_attention_block_plain"] == 0
          and uly_counts["flash_block_bwd"] == 0,
          "the Ulysses step did not run K4 and K7 once per layer per step "
          "(and nothing else)")
    del up, uo

    # from the same weights and batch: the ring step against the dense
    # step, gradients and updated leaves at the card LM step test's bars
    x, y = batches[0]
    ring_loss = lambda p: lm_mod.nll_loss(
        lm_mod.ring_forward(p, x, cfg, group), y)
    _, rg = lm_mod.value_and_grad(ring_loss, p0)
    _, dg = lm_mod.value_and_grad(
        lambda p: lm_mod.loss_fn(p, x, y, cfg), p0)
    rg, dg = lm_mod._named(rg), lm_mod._named(dg)
    qkv = {k: rg[f"blocks.{k}"].abs().max().item()
           for k in ("Wq", "Wk", "Wv")}
    grad_err = leaf_errors(rg, dg)
    del rg, dg
    opt0 = lm_mod.init_opt_state(p0, False)
    rp, _, rloss = lm_mod.make_ring_train_step(cfg, group)(p0, opt0, x, y)
    dp, _, dloss = lm_mod.make_train_step(cfg)(p0, opt0, x, y)
    leaf_err = leaf_errors(lm_mod._named(rp), lm_mod._named(dp))
    flips = sum(int(((rp_ - p0_).sign() != (dp_ - p0_).sign()).sum())
                for rp_, dp_, p0_ in zip(lm_mod.tree_leaves(rp),
                                         lm_mod.tree_leaves(dp),
                                         lm_mod.tree_leaves(p0)))
    n_params = sum(a.numel() for a in lm_mod.tree_leaves(p0))
    del rp, dp, opt0
    loss_err = abs(float(rloss) - float(dloss)) / abs(float(dloss))
    worst_g = max(grad_err, key=grad_err.get)
    worst_p = max(leaf_err, key=leaf_err.get)
    print(f"first step, ring vs dense make_train_step from the same "
          f"weights and batch: loss {float(rloss):.6f} vs "
          f"{float(dloss):.6f} (relative {loss_err:.3e}, tol "
          f"{TOL_STEP_LOSS}); gradients: worst {worst_g} "
          f"{grad_err[worst_g]:.3e}; updated leaves: worst {worst_p} "
          f"{leaf_err[worst_p]:.3e} of each leaf's largest entry (tol "
          f"{TOL_BWD_BF16} attention weights, {TOL_STEP_REST} the rest); "
          f"{flips} of {n_params} updates differ in sign; largest |grad| "
          f"of Wq, Wk, Wv {qkv}")
    check(min(qkv.values()) > 0, "no ring gradient reached Wq, Wk or Wv")
    check(loss_err <= TOL_STEP_LOSS,
          "the ring step's loss disagrees with the dense step's")
    check(all(e <= lm_bar(k, TOL_BWD_BF16, TOL_STEP_REST)
              for k, e in grad_err.items()),
          "the ring step's gradients disagree with the dense step's")
    check(all(e <= lm_bar(k, TOL_BWD_BF16, TOL_STEP_REST)
              for k, e in leaf_err.items()),
          "the ring step's updated leaves disagree with the dense step's")

    ring_ms = time_ms(lambda: lm.fit(x, y), iters=3, warmup=1)
    uly_ms = time_ms(lambda: uly(lm.params, lm.opt, x, y), iters=3,
                     warmup=1)
    adam_ms, _ = profile_ms(lambda: lm_mod._adam_update(
        lm.params, lm.opt["m"], lm.opt,
        torch.tensor(LM_LR, device=dev)), n=3)
    prof = {}
    for name, fn, ms, fwd in (
            ("ring", lambda: lm.fit(x, y), ring_ms, "K5 flash_fwd_tc<bf16>"),
            ("ulysses", lambda: uly(lm.params, lm.opt, x, y), uly_ms,
             "K4 flash_fwd_tc<bf16>")):
        busy, groups, rows = step_profile(fn, ms, fwd, adam_ms)
        tok_s = RT_N * RT_T / ms * 1e3
        print(f"{name} step: {ms:.3f} ms, {tok_s:.0f} training tokens/s; "
              f"kernels {busy:.3f} ms ({busy / ms:.1%}): " + ", ".join(
                  f"{k} {v:.3f} ms" for k, v in groups.items()))
        for ms_, calls, kname in rows[:8]:
            print(f"  {ms_:8.4f} ms  x{calls:<3d} {kname[:100]}")
        prof[name] = dict(step_ms=ms, tokens_per_s=tok_s,
                          device_busy_ms=busy, groups=groups,
                          kernels=[dict(ms=r[0], calls=r[1], name=r[2][:120])
                                   for r in rows[:12]])
    peak = torch.cuda.max_memory_allocated() - held
    print(f"ring training phase: peak device memory {peak / 2**30:.3f} GiB "
          "above what the earlier phases hold")
    del lm, p0

    print("== K7 with an lse cotangent: the in-process ring's backward ==")
    h, d = cfg.n_heads, cfg.d_model // cfg.n_heads
    chains = {}
    q, k, v, _ = ext_inputs(RT_N, RT_T, RT_T, h, d, seed + 21, dev)
    chains["lm_layer"] = check_ring_backward(
        f"the LM's layer N={RT_N} T={RT_T} H={h} D={d} bf16 causal",
        q, k, v, None, seed)
    n, t, hh, dd = EXT_MASKED
    q, k, v, km = ext_inputs(n, t, t, hh, dd, seed + 22, dev,
                             keep=EXT_KEEP)
    chains["b"] = check_ring_backward(
        f"b: masked N={n} T={t} H={hh} D={dd} bf16 causal, keep "
        f"{EXT_KEEP}", q, k, v, km, seed)
    del q, k, v, km
    return counts, uly_counts, {
        "steps": steps, "loss_per_fit": losses, "fit_batches_losses": multi,
        "ulysses_losses": uly_losses, "wall_s": wall, "launches": counts,
        "ulysses_launches": uly_counts, "qkv_grad_max": qkv,
        "first_step_vs_dense": {"loss_rel_err": loss_err,
                                "grad_errs": grad_err,
                                "leaf_errs": leaf_err,
                                "update_sign_flips": flips,
                                "n_params": n_params},
        "profile": prof, "peak_memory_bytes": peak,
        "ring_backward": chains}


def mha_conf(seed: int):
    return (NeuralNetConfiguration.builder().seed(seed)
            .learning_rate(MHA_LR).updater("adam").list()
            .layer(0, L.MultiHeadAttention(n_in=MHA_F, n_out=MHA_W,
                                           num_heads=MHA_HEADS,
                                           activation="tanh"))
            .layer(1, L.MultiHeadAttention(n_in=MHA_W, n_out=MHA_W,
                                           num_heads=MHA_HEADS,
                                           activation="tanh"))
            .layer(2, L.RnnOutputLayer(n_in=MHA_W, n_out=MHA_CLASSES,
                                       activation="softmax",
                                       loss_function="mcxent"))
            .build())


def mha_batch(seed: int, dev):
    """N x T sequences of MHA_F features with lengths in [64, T]: each
    step's class is the argmax of a fixed random projection of its
    features plus a skewed prior, so there is something to learn."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((MHA_N, MHA_T, MHA_F)).astype(np.float32)
    proj = np.random.default_rng(1234).standard_normal(
        (MHA_F, MHA_CLASSES)).astype(np.float32)
    prior = np.linspace(2.0, 0.0, MHA_CLASSES, dtype=np.float32)
    y = np.eye(MHA_CLASSES, dtype=np.float32)[
        np.argmax(x @ proj + prior, axis=-1)]
    lengths = rng.integers(64, MHA_T + 1, MHA_N)
    mask = (np.arange(MHA_T)[None] < lengths[:, None]).astype(np.float32)
    up = lambda a: torch.from_numpy(a).to(dev)
    return up(x), up(y), up(mask)


class _PlainBlock:
    """Stands in for FlashBlockFn: autograd through K5's plain version."""

    @staticmethod
    def apply(q, k, v, key_mask, offset):
        return flash_attention_block_plain(q, k, v, offset=offset,
                                           key_mask=key_mask)


def mha_grads(net: MultiLayerNetwork, x, y, mask):
    leaves = [{k: v.detach().requires_grad_() for k, v in p.items()}
              for p in net.params]
    loss, _ = net._loss(leaves, net.states, x, y, train=True,
                        step=net.iteration, mask=mask)
    flat = [v for p in leaves for v in p.values()]
    names = [f"{i}.{k}" for i, p in enumerate(leaves) for k in p]
    return names, torch.autograd.grad(loss, flat)


def phase_mha_train(seed: int, dev):
    print("== training: a masked MultiHeadAttention network ==")
    net = MultiLayerNetwork(mha_conf(seed), device=dev).init()
    print(f"MultiLayerNetwork: 2 MultiHeadAttention({MHA_W}, {MHA_HEADS} "
          f"heads) + RnnOutputLayer({MHA_CLASSES}), f32, Adam lr {MHA_LR}, "
          f"{net.num_params()} parameters; {MHA_FITS} fits of N={MHA_N} "
          f"T={MHA_T}, lengths 64-{MHA_T}")
    batches = [mha_batch(seed + i, dev) for i in range(MHA_FITS)]
    kernels = (flash_attention_block, flash_attention_block_plain,
               flash_attention, flash_attention_plain, flash_bwd,
               flash_block_bwd)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(net.fit(*b)) for b in batches]
    wall = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in kernels}
    print("loss per fit: " + " ".join(f"{v:.4f}" for v in losses))
    print(f"{MHA_FITS} fits in {wall:.3f} s ({wall / MHA_FITS * 1e3:.2f} ms "
          f"each, first calls included); launches {counts}")
    check(all(np.isfinite(losses)), "a training loss is not finite")
    check(np.mean(losses[-5:]) < losses[0], "the loss did not fall")
    check(counts["flash_attention_block"] == 2 * MHA_FITS
          and counts["flash_attention_block_plain"] == 0
          and counts["flash_attention"] == 0,
          "K5 did not launch exactly twice per fit (and nothing else)")
    check(counts["flash_bwd"] == 2 * MHA_FITS
          and counts["flash_block_bwd"] == 0,
          "K7 did not launch twice per fit (its plain version never)")
    x, y, mask = mha_batch(seed + 99, dev)
    names, got = mha_grads(net, x, y, mask)
    saved, flash_mod.FlashBlockFn = flash_mod.FlashBlockFn, _PlainBlock
    try:
        _, want = mha_grads(net, x, y, mask)
    finally:
        flash_mod.FlashBlockFn = saved
    grad_err = {n: ((a - b).abs().max()
                    / b.abs().max().clamp_min(1e-30)).item()
                for n, a, b in zip(names, got, want)}
    worst = max(grad_err, key=grad_err.get)
    print(f"one fit's gradients, K5 + K7 vs autograd through "
          f"the plain version: max error {grad_err[worst]:.3e} of the "
          f"largest entry (leaf {worst}; tol {TOL_GRAD})")
    check(grad_err[worst] <= TOL_GRAD,
          "the K5 path's gradients disagree with the plain version's")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mha.zip")
        write_model(net, path)
        loaded = MultiLayerNetwork.load(path, device=dev)
    s0, s1 = net.score(x, y, mask), loaded.score(x, y, mask)
    print(f"write_model -> MultiLayerNetwork.load: score {s0:.6f} vs "
          f"{s1:.6f}")
    check(s0 == s1 and loaded.iteration == net.iteration,
          "the saved and loaded MHA network scores differently")
    fit_ms = time_ms(lambda: net.fit(*batches[0]), iters=5, warmup=1)
    busy, rows = profile_ms(lambda: net.fit(*batches[0]), n=3)
    groups = {"K5 flash_fwd_tc<float>": 0.0, "K7 flash_bwd": 0.0,
              "GEMMs": 0.0, "other kernels (Adam, glue)": 0.0}
    for ms_, _, name in rows:
        groups[kernel_group(name, "K5 flash_fwd_tc<float>",
                            "other kernels (Adam, glue)")] += ms_
    groups["host gaps (wall - kernels)"] = fit_ms - busy
    print(f"fit: {fit_ms:.3f} ms per call; kernels {busy:.3f} ms "
          f"({busy / fit_ms:.1%}): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in groups.items()))
    for ms_, calls, name in rows[:10]:
        print(f"  {ms_:8.4f} ms  x{calls:<3d} {name[:100]}")
    return counts, {"fits": MHA_FITS, "loss_per_fit": losses,
                    "wall_s": wall, "grad_max_err": grad_err[worst],
                    "fit_ms": fit_ms,
                    "profile": dict(device_busy_ms=busy, groups=groups,
                                    kernels=[dict(ms=r[0], calls=r[1],
                                                  name=r[2][:120])
                                             for r in rows[:12]])}


def kernel_group(name: str, fwd: str, other: str) -> str:
    """A profiler kernel's group: the flash forward, K7, GEMMs, other."""
    low = name.lower()
    if "flash_fwd" in name:
        return fwd
    if "flash_bwd" in name:
        return "K7 flash_bwd"
    if "gemm" in low or "xmma" in low or "nvjet" in low or "cutlass" in low:
        return "GEMMs"
    return other


# ---------------------------------------------------------------------------
# K7: the flash backward
# ---------------------------------------------------------------------------


def bwd_inputs(n: int, tq: int, tk: int, h: int, d: int, seed: int, dev,
               dtype=torch.bfloat16, keep: float = 0.0, offset: int = 0,
               with_glse: bool = False):
    """K7's arguments: K5's inputs, (o, lse) of its plain forward, seeded
    cotangents g (and g_lse)."""
    q, k, v, km = ext_inputs(n, tq, tk, h, d, seed, dev, dtype, keep)
    o, lse = flash_attention_block_plain(q, k, v, offset=offset,
                                         key_mask=km)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    go = torch.randn(o.shape, generator=g, device=dev, dtype=dtype)
    gl = (torch.randn(lse.shape, generator=g, device=dev)
          if with_glse else None)
    return q, k, v, km, offset, o, lse.float(), go, gl


def bwd_error(got, want) -> float:
    """The largest error of dq, dk, dv, each of its largest entry."""
    return max(((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp_min(1e-30)).item()
               for a, b in zip(got, want))


def check_bwd(name: str, args, tol: float) -> float:
    """K7 against its plain version on the same card inputs, two launches
    bit-equal, every gradient finite, rows of a batch row with every key
    masked exactly 0."""
    got = flash_bwd(*args)
    again = flash_bwd(*args)
    want = flash_block_bwd(*args)
    torch.cuda.synchronize()
    err = bwd_error(got, want)
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    km = args[3]
    dead = [] if km is None else [i for i in range(km.shape[0])
                                  if not bool(km[i].any())]
    zero = all(bool((a[i] == 0).all()) for a in got for i in dead)
    # masked keys: dK and dV exactly 0
    masked = km is not None and bool((km == 0).any())
    keys0 = not masked or all(bool((a[km == 0] == 0).all())
                              for a in got[1:])
    print(f"flash_bwd {name}: max error {err:.3e} of the largest entry "
          f"(tol {tol}); finite {finite}; two launches bit-equal {same}"
          + (f"; all-masked rows {dead} exactly 0: {zero}" if dead else "")
          + (f"; masked keys' dK, dV exactly 0: {keys0}" if masked else ""))
    check(err <= tol and finite and same and zero and keys0,
          f"flash_bwd disagrees with its plain version ({name})")
    return err


def phase_kernels_bwd(seed: int, dev):
    print("== K7 (the flash backward) against its plain version, "
          "flash_block_bwd ==")
    bf, f32 = torch.bfloat16, torch.float32
    errs = {}
    cfg = lm_cfg(seed)
    h, d = cfg.n_heads, cfg.d_model // cfg.n_heads
    errs["train"] = check_bwd(
        f"train: the LM's layer N={LM_BATCH} T={LM_T} H={h} D={d} bf16 "
        "causal", bwd_inputs(LM_BATCH, LM_T, LM_T, h, d, seed, dev),
        TOL_BWD_BF16)
    errs["h"] = check_bwd(
        f"h: MHA fit N={MHA_N} T={MHA_T} H={MHA_HEADS} "
        f"D={MHA_W // MHA_HEADS} f32, lengths 64-{MHA_T}, off={MHA_T}",
        mha_bwd_inputs(seed, dev), TOL_BWD_F32)
    n, t, hh, dd = EXT_MASKED
    errs["b"] = check_bwd(
        f"b: masked N={n} T={t} H={hh} D={dd} bf16 causal, keep "
        f"{EXT_KEEP}, g_lse", bwd_inputs(n, t, t, hh, dd, seed, dev,
                                         keep=EXT_KEEP, with_glse=True),
        TOL_BWD_BF16)
    errs["c"] = check_bwd(
        "c: T=1024 H=8 D=64 bf16 off=-512 (rows with no visible key), "
        "g_lse", bwd_inputs(2, 1024, 1024, 8, 64, seed, dev, offset=-512,
                            with_glse=True), TOL_BWD_BF16)
    args = bwd_inputs(3, 512, 512, 8, 64, seed, dev, keep=0.8, offset=512)
    args[3][1] = 0.0  # batch row 1: every key masked (lse -inf)
    o, lse = flash_attention_block_plain(*args[:3], offset=512,
                                         key_mask=args[3])
    args = args[:5] + (o, lse.float()) + args[7:]
    errs["e"] = check_bwd("e: batch row 1 with every key masked, T=512 "
                          "bf16 off=512", args, TOL_BWD_BF16)
    for dd, dtype, tol in ((32, f32, TOL_BWD_F32), (128, f32, TOL_BWD_F32),
                           (16, bf, TOL_BWD_BF16), (128, bf, TOL_BWD_BF16)):
        errs[f"f{dd}{'f32' if dtype == f32 else 'bf16'}"] = check_bwd(
            f"f: D={dd} {dtype} ragged Tq=300 Tk=420 H=4 masked off=60",
            bwd_inputs(2, 300, 420, 4, dd, seed, dev, dtype, keep=0.8,
                       offset=60, with_glse=True), tol)
    return {"flash_bwd": {"max_err": max(errs.values()), "cases": errs}}


def mha_bwd_inputs(seed: int, dev):
    """K7's arguments at a layer of the masked MHA fit (case h)."""
    q, k, v, _ = ext_inputs(MHA_N, MHA_T, MHA_T, MHA_HEADS,
                            MHA_W // MHA_HEADS, seed, dev, torch.float32)
    km = mha_batch(seed, dev)[2]
    o, lse = flash_attention_block_plain(q, k, v, offset=MHA_T, key_mask=km)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    return (q, k, v, km, MHA_T, o, lse,
            torch.randn(o.shape, generator=g, device=dev), None)


def sdpa_backward(q, k, v, g, km, causal: bool):
    """One call: the backward of ``scaled_dot_product_attention`` on these
    inputs (its forward run once, outside the timing)."""
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    t = q.shape[1]
    if km is None:
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
    else:
        allowed = (km > 0)[:, None, None, :]
        if causal:
            allowed = allowed & torch.ones((t, t), dtype=torch.bool,
                                           device=q.device).tril()[None,
                                                                   None]
        o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=allowed)
    gs = g.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(o, (qs, ks, vs), gs,
                                       retain_graph=True)


def phase_times_bwd(seed: int, dev):
    print("== times: K7, its plain version and the backward of "
          "scaled_dot_product_attention (CUDA events; queued behind a "
          "sleep kernel, and back to back) ==")
    torch.backends.cuda.matmul.allow_tf32 = False  # strict f32 (case h)
    res = {"flash_bwd": {}}
    cfg = lm_cfg(seed)
    h, d = cfg.n_heads, cfg.d_model // cfg.n_heads
    for case, args, causal in (
            ("train", bwd_inputs(LM_BATCH, LM_T, LM_T, h, d, seed, dev),
             True),
            ("h", mha_bwd_inputs(seed, dev), False)):
        q, k, v, km, off, o, lse, g, _ = args
        kern = lambda: flash_bwd(*args)
        ms, ev = device_ms(kern, iters=10), time_ms(kern, iters=10)
        plain = time_ms(lambda: flash_block_bwd(*args), iters=3, warmup=1)
        lib_fn = sdpa_backward(q, k, v, g, km, causal)
        lib = device_ms(lib_fn, iters=10)
        b_ms, b_by, pairs = ext_bound(q, km, off, tensors=8, flops=10.0)
        # K7's own launches in one call, read from the profiler's records
        per_call = launches_in_one_call(kern, "flash_bwd_")
        n, t = q.shape[:2]
        kind = ("bf16 causal" if causal
                else "f32, the MHA fit's length mask, off=T")
        res["flash_bwd"][case] = dict(
            shape=f"N={n} T={t} H={q.shape[2]} D={q.shape[3]} {kind}",
            ms=ms, events_ms=ev, plain_ms=plain, library_ms=lib,
            bound_ms=b_ms, bound_by=b_by, gflop=10.0 * q.shape[3] * pairs
            / 1e9, launches_per_call=per_call)
        print(f"flash_bwd {case} ({res['flash_bwd'][case]['shape']}): "
              f"{ms:.4f} ms on the device ({ev:.4f} back to back), plain "
              f"{plain:.4f} ms, sdpa backward {lib:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; {10.0 * q.shape[3] * pairs / 1e9:.2f}"
              f" GFLOP of five products over the visible pairs), "
              f"{10.0 * q.shape[3] * pairs / ms / 1e9:.1f} TFLOP/s; "
              f"{per_call} kernel launches per call (profiler)")
    return res


# ---------------------------------------------------------------------------
# the LM's training and sampling
# ---------------------------------------------------------------------------


def lm_cfg(seed: int) -> TransformerConfig:
    """``bench.py:356`` ``_transformer_bench_cfg``: d_model 2048, 4 layers,
    32 heads, d_ff 8192, vocab 8192, max_len 1024, bf16 compute with f32
    masters, lr 1e-4."""
    return TransformerConfig(vocab_size=8192, d_model=2048, n_layers=4,
                             n_heads=32, d_ff=8192, max_len=LM_T,
                             dtype_policy="performance", use_flash=True,
                             learning_rate=LM_LR, seed=seed)


def markov_tokens(seed: int, shape, vocab: int):
    """Token ids [..., T + 1] from a fixed random Markov chain: each token
    is followed by one of ``LM_SUCCESSORS`` fixed successors (uniformly),
    so a model can learn ~log(LM_SUCCESSORS) nats of it."""
    succ = np.random.default_rng(1234).integers(0, vocab,
                                                (vocab, LM_SUCCESSORS))
    rng = np.random.default_rng(seed)
    *lead, t1 = shape
    rows = int(np.prod(lead))
    ids = np.empty((rows, t1), np.int64)
    ids[:, 0] = rng.integers(0, vocab, rows)
    pick = rng.integers(0, LM_SUCCESSORS, (rows, t1))
    for j in range(1, t1):
        ids[:, j] = succ[ids[:, j - 1], pick[:, j]]
    return ids.reshape(shape)


def lm_batch(seed: int, dev, k=None):
    shape = ((LM_BATCH, LM_T + 1) if k is None
             else (k, LM_BATCH, LM_T + 1))
    ids = torch.from_numpy(markov_tokens(seed, shape, 8192)).to(dev)
    return ids[..., :-1], ids[..., 1:]


def phase_lm_train(seed: int, dev):
    print("== training and sampling: the bench TransformerLM ==")
    cfg = lm_cfg(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    lm = TransformerLM(cfg, device=dev)
    n_params = sum(x.numel() for x in lm_mod.tree_leaves(lm.params))
    print(f"TransformerLM: d_model {cfg.d_model}, {cfg.n_layers} layers, "
          f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"bf16 compute, f32 masters, Adam lr {cfg.learning_rate}, "
          f"{n_params} parameters; {LM_FITS} fits then fit_batches of "
          f"{LM_MULTI}, batch {LM_BATCH} x T={LM_T}, a Markov token stream "
          f"of {LM_SUCCESSORS} successors a token")
    batches = [lm_batch(seed + i, dev) for i in range(LM_FITS)]
    xs, ys = lm_batch(seed + 100, dev, k=LM_MULTI)
    kernels = (flash_attention, flash_bwd, flash_attention_plain,
               flash_block_bwd)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(lm.fit(x, y)) for x, y in batches]
    multi = [float(v) for v in lm.fit_batches(xs, ys)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in kernels}
    steps = LM_FITS + LM_MULTI
    peak_abs = torch.cuda.max_memory_allocated()
    peak = peak_abs - held
    print("loss per fit: " + " ".join(f"{v:.4f}" for v in losses)
          + "; fit_batches: " + " ".join(f"{v:.4f}" for v in multi))
    print(f"{steps} steps in {wall:.3f} s (first calls included); "
          f"launches {counts}; peak device memory {peak / 2**30:.3f} GiB "
          "above what the earlier phases hold")
    check(all(np.isfinite(losses + multi)), "a training loss is not finite")
    check(np.mean(multi) < losses[0] and multi[-1] < losses[0],
          "the loss did not fall")
    check(lm.iteration == steps and int(lm.opt["t"]) == steps,
          "the iteration is not the step count")
    check(counts["flash_attention"] == counts["flash_bwd"]
          == cfg.n_layers * steps,
          "K4 and K7 did not launch once per layer per step")
    check(counts["flash_attention_plain"] == 0
          and counts["flash_block_bwd"] == 0,
          "a plain flash version ran while training on the card")
    grads = lm_mod.value_and_grad(
        lambda p: lm_mod.loss_fn(p, batches[0][0], batches[0][1], cfg),
        lm.params)[1]["blocks"]
    qkv = {k: grads[k].abs().max().item() for k in ("Wq", "Wk", "Wv")}
    print(f"largest |gradient| of Wq, Wk, Wv: {qkv}")
    check(min(qkv.values()) > 0, "no gradient reached Wq, Wk or Wv")
    del grads

    x, y = batches[0]
    step_ms = time_ms(lambda: lm.fit(x, y), iters=5, warmup=1)
    busy, rows = profile_ms(lambda: lm.fit(x, y), n=3)
    adam_busy, _ = profile_ms(lambda: lm_mod._adam_update(
        lm.params, lm.opt["m"], lm.opt,
        torch.tensor(LM_LR, device=dev)), n=3)
    groups = {"K4 flash_fwd_tc<bf16>": 0.0, "K7 flash_bwd": 0.0,
              "GEMMs": 0.0, "other kernels": 0.0}
    for ms_, _, name in rows:
        groups[kernel_group(name, "K4 flash_fwd_tc<bf16>",
                            "other kernels")] += ms_
    groups["Adam (its kernels, profiled alone)"] = adam_busy
    groups["other kernels"] -= adam_busy
    groups["host gaps (wall - kernels)"] = step_ms - busy
    tok_s = LM_BATCH * LM_T / step_ms * 1e3
    print(f"fit: {step_ms:.3f} ms per step, {tok_s:.0f} training tokens/s; "
          f"kernels {busy:.3f} ms ({busy / step_ms:.1%}): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in groups.items()))
    for ms_, calls, name in rows[:12]:
        print(f"  {ms_:8.4f} ms  x{calls:<3d} {name[:100]}")
    variants = lm_step_variants(lm, x, y)

    probe = lm_batch(seed + 200, dev)[0][:2, :256]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lm.zip")
        t0 = time.perf_counter()
        lm.save(path)
        t1 = time.perf_counter()
        loaded = TransformerLM.load(path, device=dev)
        torch.cuda.synchronize()
        io_s = (t1 - t0, time.perf_counter() - t1)
        size = os.path.getsize(path)
    same = torch.equal(lm.logits(probe), loaded.logits(probe))
    print(f"save -> TransformerLM.load ({size / 2**30:.3f} GiB in "
          f"{tempfile.gettempdir()}: save {io_s[0]:.1f} s, load "
          f"{io_s[1]:.1f} s): iteration {loaded.iteration}, logits "
          f"bit-equal: {same}")
    check(same and loaded.iteration == lm.iteration,
          "the saved and loaded LM differs from the trained one")
    del loaded

    prompt = lm_batch(seed + 300, dev)[0][:2, :64]
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    out = lm.generate(prompt, 32, temperature=0.8, seed=seed, top_k=40,
                      top_p=0.9)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check(out.shape == (2, 32) and bool((out >= 0).all())
          and bool((out < cfg.vocab_size).all()),
          f"generate gave {tuple(out.shape)} tokens out of range")
    check(flash_attention.launches == cfg.n_layers
          and flash_attention_plain.launches == 0,
          "generate's prefill did not run K4 once per layer")
    print(f"generate top_k=40 top_p=0.9, 2 prompts of 64, 32 new tokens: "
          f"{gen_s:.3f} s (prefill through K4, then dense-cache decode "
          "steps)")
    eng = ServingEngine(lm, kv_blocks=256, device=dev).start()
    try:
        req = {"tokens": prompt[:1].tolist(), "n_new": 16,
               "temperature": 0.7, "seed": 3, "top_k": 40}
        status, body = _post(eng.url, req)
        want = lm.generate(prompt[:1], 16, temperature=0.7, seed=3,
                           top_k=40)
        got = json.loads(body)["tokens"]
        check(status == 200 and got == want.tolist(),
              f"HTTP /generate with top_k: {status}, {body[:200]}")
        try:
            _post(eng.url, dict(req, stream=True))
            refused = None
        except urllib.error.HTTPError as e:
            refused = e.code
        check(refused == 400, "a streamed request with top_k was not "
              "refused with 400")
    finally:
        eng.stop()
    print("HTTP /generate with top_k: 200 with lm.generate's tokens; with "
          "stream: 400")
    return lm, counts, {"steps": steps, "loss_per_fit": losses,
                        "fit_batches_losses": multi, "wall_s": wall,
                        "launches": counts, "step_ms": step_ms,
                        "tokens_per_s": tok_s, "peak_memory_bytes": peak,
                        "peak_abs_bytes": peak_abs,
                        "step_variants": variants, "qkv_grad_max": qkv,
                        "checkpoint_bytes": size,
                        "checkpoint_io_s": io_s, "generate_s": gen_s,
                        "profile": dict(device_busy_ms=busy, groups=groups,
                                        kernels=[dict(ms=r[0], calls=r[1],
                                                      name=r[2][:120])
                                                 for r in rows[:12]])}


class env_set:
    """Within it, the given environment variables hold these values; on
    leaving, each is restored (or removed)."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def lm_step_variants(lm: TransformerLM, x, y):
    """ms and peak device memory of one dense step of ``lm`` by default,
    under each remat rung and under bf16 loss scaling (the knobs set while
    the step is built and run; peak memory above what was allocated
    before the step)."""
    out = {}
    for name, env in (("default", {}),
                      ("DL4J_TPU_REMAT=dots", {"DL4J_TPU_REMAT": "dots"}),
                      ("DL4J_TPU_REMAT=block", {"DL4J_TPU_REMAT": "block"}),
                      ("DL4J_TPU_BF16=1", {"DL4J_TPU_BF16": "1"})):
        with env_set(**env):
            step = lm_mod.make_train_step(lm.cfg)
            opt = (lm_mod.init_opt_state(lm.params, True)
                   if step.loss_scaled else lm.opt)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = time_ms(lambda: step(lm.params, opt, x, y), iters=3,
                         warmup=1)
            peak = torch.cuda.max_memory_allocated() - base
            loss = float(step(lm.params, opt, x, y)[2])
        del opt
        out[name] = {"ms": ms, "peak_bytes": peak, "loss": loss}
        print(f"dense step {name}: {ms:.3f} ms, peak {peak / 2**30:.3f} GiB "
              f"above the model and its optimizer state, loss {loss:.4f}")
        check(np.isfinite(loss), f"the {name} step's loss is not finite")
    return out


# ---------------------------------------------------------------------------
# BERT: MLM pretraining, fine-tuning and embeddings
# ---------------------------------------------------------------------------


def bert_tokens(seed: int, k=None):
    """[(K,) BERT_N, BERT_T] ids 1 .. V-1 from the Markov stream; each row
    keeps a length drawn from [BERT_MIN_LEN, BERT_T] and pads the rest."""
    shape = (BERT_N, BERT_T) if k is None else (k, BERT_N, BERT_T)
    ids = 1 + markov_tokens(seed, shape, BERT_KW["vocab_size"] - 1)
    rows = ids.reshape(-1, BERT_T)
    lengths = np.random.default_rng(seed + 7).integers(
        BERT_MIN_LEN, BERT_T + 1, rows.shape[0])
    rows[np.arange(BERT_T)[None] >= lengths[:, None]] = 0
    return rows.reshape(shape)


def planted_rows(seed: int, n: int):
    """n rows and two-class labels: a class-c row's real tokens are drawn
    from its own 8 ids (1000-1007 for class 1, 2000-2007 for class 0);
    lengths as :func:`bert_tokens`'."""
    rng = np.random.default_rng(seed)
    labels = rng.permutation(np.arange(n) % 2)
    ids = np.where(labels[:, None] == 1, 1000, 2000) \
        + rng.integers(0, 8, (n, BERT_T))
    lengths = rng.integers(BERT_MIN_LEN, BERT_T + 1, n)
    ids[np.arange(BERT_T)[None] >= lengths[:, None]] = 0
    return ids, labels


def dense_bi_attention(q, k, v, n_heads: int, key_mask):
    """The JAX package's ``_bi_attention`` (``bert.py:115``): scores with
    -1e9 at masked keys, softmax in f32; an all-pad sequence attends
    uniformly."""
    n, t, d = q.shape
    hd = d // n_heads
    qh, kh, vh = (a.reshape(n, t, n_heads, hd) for a in (q, k, v))
    s = torch.einsum("nqhd,nkhd->nhqk", qh, kh) / hd ** 0.5
    s = s.masked_fill(~key_mask[:, None, None, :], -1e9)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("nhqk,nkhd->nqhd", p, vh).reshape(n, t, d)


class jax_attention:
    """Within it, BERT's encoder attends by :func:`dense_bi_attention`."""

    def __enter__(self):
        self.saved = bert_mod._bi_attention
        bert_mod._bi_attention = dense_bi_attention
        return self

    def __exit__(self, *exc):
        bert_mod._bi_attention = self.saved
        return False


def bert_kernel_times(batch, seed: int, dev):
    """K5 and K7 at BERT's layer (N, T, H, D) = (BERT_N, BERT_T, 12, 64),
    f32, offset T, the phase's key mask: against their plain versions,
    timed beside them, SDPA with the equivalent boolean mask (TF32 off; its
    backward for K7) and the bounds."""
    torch.backends.cuda.matmul.allow_tf32 = False
    h = BERT_KW["n_heads"]
    d = BERT_KW["d_model"] // h
    km = torch.from_numpy((batch != 0).astype(np.float32)).to(dev)
    q, k, v, _ = ext_inputs(BERT_N, BERT_T, BERT_T, h, d, seed + 31, dev,
                            torch.float32)
    shape = f"N={BERT_N} T={BERT_T} H={h} D={d} f32, lengths " \
            f"{BERT_MIN_LEN}-{BERT_T}, off={BERT_T}"
    eo, el = check_ext(f"bert: {shape}", q, k, v, km, BERT_T, TOL_EXT_F32,
                       TOL_EXT_F32)
    o, lse = flash_attention_block_plain(q, k, v, offset=BERT_T,
                                         key_mask=km)
    g = torch.randn(o.shape, generator=torch.Generator(device=dev)
                    .manual_seed(seed + 32), device=dev)
    args = (q, k, v, km, BERT_T, o, lse, g, None)
    e7 = check_bwd(f"bert: {shape}", args, TOL_BWD_F32)
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    allowed = (km > 0)[:, None, None, :]
    res = {}
    for name, kern, plain, lib, tensors, flops, err in (
            ("flash_attention_block",
             lambda: flash_attention_block(q, k, v, offset=BERT_T,
                                           key_mask=km),
             lambda: flash_attention_block_plain(q, k, v, offset=BERT_T,
                                                 key_mask=km),
             lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                    attn_mask=allowed),
             4, 4.0, eo),
            ("flash_bwd", lambda: flash_bwd(*args),
             lambda: flash_block_bwd(*args),
             sdpa_backward(q, k, v, g, km, causal=False), 8, 10.0, e7)):
        ms, ev = device_ms(kern, iters=10), time_ms(kern, iters=10)
        plain_ms = time_ms(plain, iters=3, warmup=1)
        lib_ms = device_ms(lib, iters=10)
        b_ms, b_by, pairs = ext_bound(q, km, BERT_T, tensors=tensors,
                                      flops=flops)
        gflop = flops * d * pairs / 1e9
        res[name] = dict(shape=shape, ms=ms, events_ms=ev,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by, gflop=gflop, max_err=err)
        print(f"{name} bert ({shape}): {ms:.4f} ms on the device ({ev:.4f} "
              f"back to back), plain {plain_ms:.4f} ms, sdpa"
              f"{' backward' if tensors == 8 else ''} {lib_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; {gflop:.2f} GFLOP over the visible "
              f"pairs), {gflop / ms:.1f} TFLOP/s")
    res["flash_attention_block"]["max_err_lse"] = el
    return res


def phase_bert(seed: int, dev):
    print("== BERT: MLM pretraining, fine-tuning and embeddings at "
          "BERT-base widths ==")
    cfg = bert_mod.BertConfig(**BERT_KW, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    mlm = bert_mod.BertMLM(cfg, device=dev)
    L = cfg.n_layers
    n_params = sum(x.numel() for x in lm_mod.tree_leaves(mlm.params))
    batches = [bert_tokens(seed + i) for i in range(BERT_FITS)]
    stack = bert_tokens(seed + 100, k=BERT_MULTI)
    real = int((batches[0] != 0).sum())
    print(f"BertMLM: vocab {cfg.vocab_size}, d_model {cfg.d_model}, {L} "
          f"layers, {cfg.n_heads} heads, d_ff {cfg.d_ff}, max_len "
          f"{cfg.max_len}, pad {cfg.pad_token_id}, [MASK] {cfg.mask_id}, "
          f"strict f32, Adam lr {cfg.learning_rate}, {n_params} parameters; "
          f"{BERT_FITS} fits then fit_batches of {BERT_MULTI}, batch "
          f"{BERT_N} x T={BERT_T}, lengths {BERT_MIN_LEN}-{BERT_T} "
          f"({real} real tokens in the first batch)")
    # the 8 training batches under the masks fit and fit_batches will draw
    # (a copy of the model's generator): their mean loss before and after
    # training (each step's own loss is on a new batch and mask)
    rng = copy.deepcopy(mlm._rng)
    masked = [[torch.as_tensor(a, device=dev)
               for a in bert_mod.mask_tokens(b, cfg, rng)]
              for b in batches + list(stack)]

    def train_loss():
        with torch.inference_mode():
            return float(np.mean([float(bert_mod.mlm_loss(mlm.params, *m,
                                                          cfg))
                                  for m in masked]))

    before = train_loss()
    kernels = (flash_attention_block, flash_attention_block_plain,
               flash_attention, flash_attention_plain, flash_bwd,
               flash_block_bwd)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [mlm.fit(b) for b in batches]
    last = mlm.fit_batches(stack)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in kernels}
    steps = BERT_FITS + BERT_MULTI
    after = train_loss()
    print("MLM loss per fit: " + " ".join(f"{v:.4f}" for v in losses)
          + f"; fit_batches' last: {last:.4f}; {steps} steps in {wall:.3f} "
          f"s (first calls included); launches {counts}; the 8 masked "
          f"batches' mean loss {before:.4f} before training, {after:.4f} "
          "after")
    check(all(np.isfinite(losses + [last, after])),
          "an MLM loss is not finite")
    check(after < before, "the MLM loss of the training batches did not "
          "fall")
    check(int(mlm.opt["t"]) == steps, "Adam's t is not the step count")
    check(counts["flash_attention_block"] == counts["flash_bwd"] == L * steps
          and counts["flash_attention_block_plain"] == 0
          and counts["flash_block_bwd"] == 0
          and counts["flash_attention"] == 0
          and counts["flash_attention_plain"] == 0,
          "BERT did not run K5 and K7 once per layer per step (and nothing "
          "else)")
    x, y, w = mlm._masked(batches[0])
    grads = lm_mod.value_and_grad(
        lambda p: bert_mod.mlm_loss(p, x, y, w, cfg), mlm.params)[1]
    qkv = {k: grads["blocks"][k].abs().max().item()
           for k in ("Wq", "Wk", "Wv")}
    del grads
    print(f"largest |gradient| of Wq, Wk, Wv: {qkv}")
    check(min(qkv.values()) > 0, "no gradient reached Wq, Wk or Wv")

    probe = batches[1][:2]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bert.zip")
        mlm.save(path)
        loaded = bert_mod.BertMLM.load(path, device=dev)
        size = os.path.getsize(path)
    same = bool(np.array_equal(mlm.predict_logits(probe),
                               loaded.predict_logits(probe)))
    print(f"save -> BertMLM.load ({size / 2**20:.1f} MiB): predict_logits "
          f"bit-equal: {same}")
    check(same and int(loaded.opt["t"]) == steps,
          "the saved and loaded BertMLM differs from the trained one")
    del loaded
    probe = batches[2][:4].copy()
    probe[2] = 0  # an all-pad row
    emb = mlm.embed_tokens(probe)
    with jax_attention():
        ref = mlm.embed_tokens(probe)
    err_pad = float(np.abs(emb[2] - ref[2]).max())
    err_all = float(np.abs(emb - ref).max())
    print(f"embed_tokens {emb.shape}: finite {bool(np.isfinite(emb).all())}"
          f"; the all-pad row against the JAX package's -1e9 attention "
          f"(the mean of V) {err_pad:.3e} (tol {TOL_EXT_F32}), every row "
          f"{err_all:.3e}")
    check(bool(np.isfinite(emb).all()) and err_pad <= TOL_EXT_F32,
          "embed_tokens is not finite or the all-pad row is not JAX's")

    ids, labels = planted_rows(seed + 300, BERT_N * FT_STEPS)
    clf = bert_mod.BertClassifier(mlm, 2)
    ft = [clf.fit(ids[i * BERT_N:(i + 1) * BERT_N],
                  labels[i * BERT_N:(i + 1) * BERT_N])
          for i in range(FT_STEPS)]
    hid, hl = planted_rows(seed + 400, FT_HELD_OUT)
    acc = clf.accuracy(hid, hl)
    print("fine-tune loss per step: " + " ".join(f"{v:.4f}" for v in ft)
          + f"; held-out accuracy {acc:.3f} on {FT_HELD_OUT} rows "
          f"(chance 0.5, bar {FT_ACCURACY})")
    check(all(np.isfinite(ft)) and acc >= FT_ACCURACY,
          "the fine-tuned classifier is not above chance")
    del clf
    frozen = bert_mod.BertClassifier(mlm, 2, encoder_lr_scale=0.0)
    head0 = frozen.state["head"]["Wc"].clone()
    for i in range(2):
        frozen.fit(ids[i * BERT_N:(i + 1) * BERT_N],
                   labels[i * BERT_N:(i + 1) * BERT_N])
    kept = all(torch.equal(a, b) for a, b in zip(
        lm_mod.tree_leaves(frozen.state["encoder"]),
        lm_mod.tree_leaves(mlm.params)))
    moved = not torch.equal(frozen.state["head"]["Wc"], head0)
    print(f"encoder_lr_scale=0: the encoder bit-equal after 2 steps: {kept}"
          f"; the head moved: {moved}")
    check(kept and moved, "encoder_lr_scale=0 moved the encoder or left "
          "the head")
    del frozen

    step = lambda: mlm._step(mlm.params, mlm.opt, x, y, w)
    step_ms = time_ms(step, iters=3, warmup=1)
    adam_ms, _ = profile_ms(lambda: lm_mod._adam_update(
        mlm.params, mlm.opt["m"], mlm.opt,
        torch.tensor(cfg.learning_rate, device=dev)), n=3)
    busy, groups, rows = step_profile(step, step_ms,
                                      "K5 flash_fwd_tc<float>", adam_ms)
    tok_s = real / step_ms * 1e3
    print(f"MLM step: {step_ms:.3f} ms, {tok_s:.0f} non-pad tokens/s; "
          f"kernels {busy:.3f} ms ({busy / step_ms:.1%}): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in groups.items()))
    for ms_, calls, name in rows[:10]:
        print(f"  {ms_:8.4f} ms  x{calls:<3d} {name[:100]}")
    peak = torch.cuda.max_memory_allocated() - held
    print(f"BERT phase: peak device memory {peak / 2**30:.3f} GiB above "
          "what the earlier phases hold")
    del mlm
    times = bert_kernel_times(batches[0], seed, dev)
    return counts, times, {
        "steps": steps, "loss_per_fit": losses, "fit_batches_last": last,
        "train_batches_loss": [before, after],
        "wall_s": wall, "launches": counts, "qkv_grad_max": qkv,
        "embed_all_pad_err": err_pad, "embed_err": err_all,
        "finetune_losses": ft, "finetune_accuracy": acc,
        "step_ms": step_ms, "tokens_per_s": tok_s, "real_tokens": real,
        "peak_memory_bytes": peak,
        "profile": dict(device_busy_ms=busy, groups=groups,
                        kernels=[dict(ms=r[0], calls=r[1], name=r[2][:120])
                                 for r in rows[:12]])}



# -- the serving planes ------------------------------------------------------


def _call(url: str, path: str, payload=None, headers=None,
          timeout: float = 600.0):
    """(status, headers, body) of one request; an HTTP error is an answer
    here, not an exception (the planes check 4xx and 5xx answers)."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url + path, data=data, method="GET" if data is None else "POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def _ok(answer, what: str):
    status, _, body = answer
    check(status == 200, f"{what}: HTTP {status}: {body[:300]}")
    return json.loads(body)


def _error(answer, status: int, kind: str, what: str):
    got, hdr, body = answer
    check(got == status and kind in body,
          f"{what}: want HTTP {status} {kind}, got {got}: {body[:300]}")
    return hdr


def mlp_conf(widths, seed: int):
    """Dense ReLU layers and a softmax head, Adam at lr 0.01: the bench
    MLPs of bench.py:1431-1437 and :2882-2888."""
    b = (NeuralNetConfiguration.builder().seed(seed).learning_rate(0.01)
         .updater("adam").list())
    last = len(widths) - 2
    for i in range(last):
        b = b.layer(i, L.DenseLayer(n_in=widths[i], n_out=widths[i + 1],
                                    activation="relu"))
    return b.layer(last, L.OutputLayer(
        n_in=widths[last], n_out=widths[-1], activation="softmax",
        loss_function="mcxent")).build()


def char_batches(seed: int, n: int, rows: int):
    """``n`` one-hot batches of ``rows`` x SEQ from the smoke's Markov
    chain over VOCAB characters."""
    chars = [chr(32 + i) for i in range(VOCAB)]
    text = markov_text(seed, n * rows * SEQ, chars)
    idx = np.frombuffer(text.encode(), np.uint8).astype(np.int64) - 32
    eye = np.eye(VOCAB, dtype=np.float32)
    return [eye[b] for b in idx.reshape(n, rows, SEQ)]


def predict_burst(url: str, reqs, model: str):
    """The requests through HTTP /predict to record ``model`` from
    N_CLIENTS threads: (answers, wall s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(N_CLIENTS) as ex:
        answers = list(ex.map(lambda x: _call(
            url, "/predict", {"batch": x.tolist(), "model": model}), reqs))
    wall = time.perf_counter() - t0
    return [np.asarray(_ok(a, f"/predict to {model}")["outputs"],
                       np.float32) for a in answers], wall


PREDICT_COUNTERS = (lstm_scan, lstm_scan_plain, lowprec.int8_matmul,
                    lowprec.int8_matmul_plain)


def predict_counts():
    return {fn.__name__: fn.launches for fn in PREDICT_COUNTERS}


def zero_predict_counts():
    for fn in PREDICT_COUNTERS:
        fn.launches = 0


def quant_leg(eng, name: str, net, calib, reqs, input_shape, tmp: str,
              rnn: bool):
    """One model's calibrated int8 leg: calibrate, write the zip with
    quant.json, load it as an f32 record (DL4J_TPU_QUANT=0) and as the
    int8 record through POST /models, warm both, serve the int8 one, and
    drive the same burst through each in turns (f32, int8, int8, f32)."""
    t_leg = time.perf_counter()
    spec = QuantCalibrator().fit(net, calib).spec(net)
    path = os.path.join(tmp, f"{name}.zip")
    write_model(net, path, quant=spec)
    shape = list(input_shape)
    with env_set(DL4J_TPU_QUANT="0"):
        f32 = _ok(_call(eng.url, "/models", {
            "action": "load", "name": f"{name}_f32", "path": path,
            "input_shape": shape}), f"load {name} f32")
    q = _ok(_call(eng.url, "/models", {
        "action": "load", "name": f"{name}_int8", "path": path,
        "input_shape": shape}), f"load {name} int8")
    check(f32["precision"] == "f32" and q["precision"] == "int8",
          f"{name}: records {f32['precision']}, {q['precision']}")
    verdict = q["quant"]
    print(f"{name}: int8 gate {verdict['verdict']}, delta "
          f"{verdict['delta']:.6g} (max {verdict['max_delta']}) on the "
          f"{spec.sample.shape[0]}-row gate sample, int8 layers "
          f"{verdict['layers']}")
    check(verdict["verdict"] == "ok", f"{name}: gate verdict {verdict}")
    for rec in (f"{name}_f32", f"{name}_int8"):
        _ok(_call(eng.url, "/models", {"action": "warmup", "name": rec,
                                       "max_batch": eng.max_batch}),
            f"warmup {rec}")
    _ok(_call(eng.url, "/models", {"action": "serve",
                                   "name": f"{name}_int8"}),
        f"serve {name}_int8")
    rows = sum(x.shape[0] for x in reqs)
    walls, counts, outs = {"f32": [], "int8": []}, {}, {}
    for kind in ("f32", "int8", "int8", "f32"):
        zero_predict_counts()
        outs[kind], wall = predict_burst(eng.url, reqs, f"{name}_{kind}")
        walls[kind].append(wall)
        counts[kind] = predict_counts()
    for kind in ("f32", "int8"):
        print(f"{name} {kind}: {len(reqs)} requests, {rows} rows: "
              + ", ".join(f"{rows / w:.1f}" for w in walls[kind])
              + f" rows/s; launches {counts[kind]}")
    c8, c32 = counts["int8"], counts["f32"]
    check(c8["int8_matmul"] > 0 and c8["int8_matmul_plain"] == 0,
          f"{name}: the int8 burst's products {c8}")
    check(c32["int8_matmul"] == 0, f"{name}: an int8 product in f32 {c32}")
    if rnn:
        check(c8["lstm_scan"] > 0 and c8["lstm_scan_plain"] == 0,
              f"{name}: K1 in the int8 burst {c8}")
    qnet = eng.registry.get(f"{name}_int8").model
    err_alone = err_f32 = 0.0
    for x, a8, a32 in zip(reqs, outs["int8"], outs["f32"]):
        check(np.isfinite(a8).all() and a8.shape == a32.shape,
              f"{name}: an int8 answer of shape {a8.shape}")
        alone = qnet.output(x).float().cpu().numpy()
        err_alone = max(err_alone, float(np.abs(a8 - alone).max()))
        err_f32 = max(err_f32, float(np.abs(a8 - a32).max()))
    print(f"{name}: max |int8 answer - QuantizedNet.output(rows alone)| "
          f"{err_alone:.3e} (tol {TOL_PREDICT}); max |int8 - f32 answer| "
          f"{err_f32:.3e} (DL4J_TPU_QUANT_MAX_DELTA {verdict['max_delta']})")
    check(err_alone <= TOL_PREDICT, f"{name}: batched int8 != alone")
    check(err_f32 <= verdict["max_delta"], f"{name}: int8 strays from f32")
    leg_s = time.perf_counter() - t_leg
    print(f"{name}: leg wall {leg_s:.1f} s")
    return path, spec, {
        "gate": verdict, "rows": rows, "requests": len(reqs),
        "rows_per_s": {k: [rows / w for w in v] for k, v in walls.items()},
        "launches": counts, "max_abs_err_vs_alone": err_alone,
        "max_abs_err_vs_f32": err_f32, "leg_s": leg_s}


def int8_head_times(seed: int, dev):
    """The int8 product (``ops/lowprec.int8_matmul``: torch._int_mm on
    zero-padded operands) at the char-RNN head's and the lowprec bench
    MLP's shapes, beside the f32 ``torch.matmul`` of the same product
    (TF32 off) and the bound; device time behind a sleep kernel. Also
    probes _int_mm's shape rules on this build."""
    probe = {}
    for m, k, n in ((16, 16, 16), (17, 16, 16), (24, 10, 16),
                    (24, 16, 10), (1, 200, 80), (24, 200, 80)):
        a = torch.ones((m, k), dtype=torch.int8, device=dev)
        b = torch.ones((k, n), dtype=torch.int8, device=dev)
        try:
            torch._int_mm(a, b)
            probe[f"{m}x{k}x{n}"] = "runs"
        except RuntimeError as e:
            probe[f"{m}x{k}x{n}"] = str(e).splitlines()[0][:90]
    print(f"torch._int_mm on this build: {probe}")
    rng = np.random.default_rng(seed)
    shapes = {"char_head_1row": (SEQ, LSTM_H, VOCAB),
              "char_head_64rows": (64 * SEQ, LSTM_H, VOCAB)}
    f, h, c = LOWPREC_MLP[0], LOWPREC_MLP[1], LOWPREC_MLP[-1]
    for name, (k, n) in (("mlp_l0", (f, h)), ("mlp_l1", (h, h)),
                         ("mlp_head", (h, c))):
        shapes[f"{name}_1row"] = (1, k, n)
        shapes[f"{name}_{QUANT_BATCH}rows"] = (QUANT_BATCH, k, n)
    out = {}
    for name, (m, k, n) in shapes.items():
        xq = torch.from_numpy(rng.integers(-127, 128, (m, k),
                                           dtype=np.int8)).to(dev)
        wq = torch.from_numpy(rng.integers(-127, 128, (k, n),
                                           dtype=np.int8)).to(dev)
        xf, wf = xq.float(), wq.float()
        acc = lowprec.int8_matmul(xq, wq)
        want = lowprec.int8_matmul_plain(xq.cpu(), wq.cpu())
        check(torch.equal(acc.cpu(), want),
              f"int8_matmul on the card != the exact product at {name}")
        ms = device_ms(lambda: lowprec.int8_matmul(xq, wq))
        f32_ms = device_ms(lambda: torch.matmul(xf, wf))
        b_ms, b_by = bound(m * k + k * n + 4 * m * n, 2.0 * m * k * n,
                           PEAK_INT8_OPS)
        out[name] = {"shape": [m, k, n], "ms": ms, "f32_matmul_ms": f32_ms,
                     "bound_ms": b_ms, "bound_by": b_by}
        print(f"int8 product {name} (M,K,N)=({m},{k},{n}): {ms:.4f} ms "
              f"(torch._int_mm, padded), f32 torch.matmul {f32_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}); bit-equal to the exact "
              "product")
    return probe, out


def prometheus_samples(text: str, owner: str):
    """{name without dl4j_serving_: value} of one engine's serving ledger
    in a text exposition."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or f'owner="{owner}"' not in line:
            continue
        name, value = line.rsplit(" ", 1)
        name = name.split("{")[0]
        if name.startswith("dl4j_serving_"):
            out[name[len("dl4j_serving_"):]] = float(value)
    return out


def flat_numbers(prefix: str, obj, out: dict) -> dict:
    """A snapshot's numeric leaves under the registry's names."""
    if isinstance(obj, bool):
        out[prefix] = 1.0 if obj else 0.0
    elif isinstance(obj, (int, float)):
        out[prefix] = float(obj)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            flat_numbers(f"{prefix}_{k}" if prefix else str(k), v, out)
    return out


def write_lm_zip(path: str, lm: TransformerLM) -> None:
    """The JAX flagship zip of ``lm`` without its optimizer section
    (serving reads none; ``TransformerLM.load`` takes the zip without
    it)."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("configuration.json",
                   json.dumps(dataclasses.asdict(lm.cfg)))
        z.writestr("coefficients.npz", tree_to_npz_bytes(lm.params))
        z.writestr("metadata.json", json.dumps({
            "format_version": 1, "model_class": "TransformerLM"}))


def phase_serving_planes(lm: TransformerLM, burst_run, seed: int, dev):
    """The serving planes on the card (``serving/engine.py``,
    ``registry.py``, ``resilience.py``, ``batcher.py``): (a) calibrated
    int8 /predict for the char-RNN and the lowprec bench's MLP, (b) the
    normalized path, (c) isolation of bad rollouts, (d) the breaker, the
    watchdog and a faulted decode admission, (e) the POST /models
    lifecycle of the bench transformer, unload, drain under a live
    stream and the Prometheus scrape."""
    print("== serving planes: int8 /predict, normalizers, the lifecycle, "
          "breaker, watchdog, drain ==")
    reqs, answers = burst_run
    rng = np.random.default_rng(seed + 7)
    out = {}
    probe, head = int8_head_times(seed, dev)
    out["int_mm_rules"], out["int8_products"] = probe, head
    chaos_a = ServingChaos(ServingChaosConfig(load_fail_name="char_bad",
                                              warmup_fail_name="char_wf"))
    eng = ServingEngine(device=dev, chaos=chaos_a).start()
    tmp = tempfile.mkdtemp(prefix="planes_")
    try:
        # (a) the char-RNN of bench.py:206 and the lowprec bench's MLP
        conf = char_rnn_conf(VOCAB, lstm_size=LSTM_H, num_layers=2,
                             seed=seed)
        cnet = MultiLayerNetwork(conf, device=dev).init(
            input_shape=(1, VOCAB))
        calib = char_batches(seed + 3, 4, 32)
        creqs = [np.eye(VOCAB, dtype=np.float32)[rng.integers(
            0, VOCAB, (int(rng.integers(1, MAX_ROWS + 1)), SEQ))]
            for _ in range(N_PREDICT)]
        char_zip, _, out["char_rnn"] = quant_leg(
            eng, "char", cnet, calib, creqs, (SEQ, VOCAB), tmp, rnn=True)
        mnet = MultiLayerNetwork(mlp_conf(LOWPREC_MLP, 7), device=dev).init()
        srng = np.random.default_rng(1)
        sx = srng.standard_normal((512, LOWPREC_MLP[0])).astype(np.float32)
        sy = np.eye(LOWPREC_MLP[-1], dtype=np.float32)[
            srng.integers(0, LOWPREC_MLP[-1], 512)]
        for i in range(0, 512, 128):  # 4 fits, bench.py:2889-2890
            mnet.fit(sx[i:i + 128], sy[i:i + 128])
        mreqs = [rng.standard_normal((int(rng.integers(1, MLP_MAX_ROWS + 1)),
                                      LOWPREC_MLP[0])).astype(np.float32)
                 for _ in range(N_PREDICT)]
        _, _, out["lowprec_mlp"] = quant_leg(
            eng, "mlp", mnet, sx[:QUANT_BATCH], mreqs, (LOWPREC_MLP[0],),
            tmp, rnn=False)
        # (b) the normalized path: the resilience bench's MLP and the
        # char-RNN, each zip with a fitted NormalizerStandardize
        t0 = time.perf_counter()
        rnet = MultiLayerNetwork(mlp_conf(RESIL_MLP, 7), device=dev).init()
        norm = NormalizerStandardize().fit(
            (rng.standard_normal((512, RESIL_MLP[0])) * 3 + 1)
            .astype(np.float32))
        rzip = os.path.join(tmp, "resil_norm.zip")
        write_model(rnet, rzip, normalizer=norm)
        cnorm = NormalizerStandardize().fit(np.concatenate(calib))
        czip = os.path.join(tmp, "char_norm.zip")
        write_model(cnet, czip, normalizer=cnorm)
        for name, path, shape in (("resil_norm", rzip, [RESIL_MLP[0]]),
                                  ("char_norm", czip, [SEQ, VOCAB])):
            d = _ok(_call(eng.url, "/models", {
                "action": "load", "name": name, "path": path,
                "input_shape": shape}), f"load {name}")
            check(d["normalizer"] == "NormalizerStandardize",
                  f"{name} carries no normalizer: {d}")
            _ok(_call(eng.url, "/models", {"action": "warmup", "name": name,
                                           "max_batch": eng.max_batch}),
                f"warmup {name}")
        rrows = [rng.standard_normal((int(rng.integers(1, MLP_MAX_ROWS + 1)),
                                      RESIL_MLP[0])).astype(np.float32)
                 for _ in range(16)]
        got, _ = predict_burst(eng.url, rrows, "resil_norm")
        err_r = max(float(np.abs(g - rnet.output(norm.transform_array(x))
                                 .cpu().numpy()).max())
                    for g, x in zip(got, rrows))
        row = rrows[0][0]
        a = _ok(_call(eng.url, "/predict", {"record": row.tolist(),
                                            "model": "resil_norm"}),
                "record")
        b = _ok(_call(eng.url, "/predict", {
            "record_base64": base64.b64encode(row.tobytes()).decode(),
            "model": "resil_norm"}), "record_base64")
        check(a["output"] == b["output"], "record_base64 != record")
        zero_predict_counts()
        got, _ = predict_burst(eng.url, creqs[:16], "char_norm")
        c_norm = predict_counts()
        err_c = max(float(np.abs(g - cnet.output(cnorm.transform_array(x))
                                 .cpu().numpy()).max())
                    for g, x in zip(got, creqs[:16]))
        print(f"normalized /predict: resilience MLP max |answer - "
              f"output(normalizer.transform(rows))| {err_r:.3e}, char-RNN "
              f"{err_c:.3e} (tol 1e-5); record_base64 == record bit for "
              f"bit; char-RNN launches {c_norm}; "
              f"{time.perf_counter() - t0:.1f} s")
        check(err_r <= 1e-5 and err_c <= 1e-5,
              "a normalized answer strays from output(transform(rows))")
        check(c_norm["lstm_scan"] > 0 and c_norm["lstm_scan_plain"] == 0,
              f"K1 in the normalized char-RNN burst: {c_norm}")
        out["normalized"] = {"max_abs_err_mlp": err_r,
                             "max_abs_err_char_rnn": err_c,
                             "launches_char_rnn": c_norm}
        # (c) isolation: a gate failure, a failed load and a failed
        # warmup land broken; the default (char_int8) keeps answering
        t0 = time.perf_counter()
        x0 = creqs[0]
        _ok(_call(eng.url, "/models", {"action": "serve",
                                       "name": "char_int8"}),
            "serve char_int8 again")
        default = eng.registry.default().key
        with env_set(DL4J_TPU_QUANT_MAX_DELTA="1e-9"):
            _error(_call(eng.url, "/models", {
                "action": "load", "name": "char_gate", "path": char_zip,
                "input_shape": [SEQ, VOCAB]}), 400, "QuantGateError",
                "a gate-failed load")
        _ok(_call(eng.url, "/predict", {"batch": x0.tolist()}),
            "the default after a gate failure")
        _error(_call(eng.url, "/models", {
            "action": "load", "name": "char_bad", "path": char_zip}), 400,
            "InjectedServingFault", "a chaos-failed load")
        _ok(_call(eng.url, "/models", {
            "action": "load", "name": "char_wf", "path": char_zip,
            "input_shape": [SEQ, VOCAB]}), "load char_wf")
        _error(_call(eng.url, "/models", {"action": "warmup",
                                          "name": "char_wf"}), 400,
               "InjectedServingFault", "a chaos-failed warmup")
        hdr = _error(_call(eng.url, "/predict", {"batch": x0.tolist(),
                                                 "model": "char_wf"}),
                     503, "broken", "/predict to a broken record")
        check(hdr.get("Retry-After") == "5", f"Retry-After {hdr}")
        _ok(_call(eng.url, "/predict", {"batch": x0.tolist()}),
            "the default after the failed rollouts")
        models = _ok(_call(eng.url, "/models"), "GET /models")
        states = {f"{m['name']}@v{m['version']}": m["state"]
                  for m in models["models"]}
        check(all(states[k] == "broken" for k in
                  ("char_gate@v1", "char_bad@v1", "char_wf@v1"))
              and models["default"] == default,
              f"isolation: {states}, default {models['default']}")
        lineage = [(e["from"], e["to"]) for e in models["lineage"]]
        print(f"isolation: gate failure, failed load, failed warmup all "
              f"broken, the default {default} answered after each; "
              f"lineage {lineage}; chaos {chaos_a.log}; "
              f"{time.perf_counter() - t0:.1f} s")
        out["isolation"] = {"states": states, "lineage": lineage}
        eng.stop()
        out["breaker"] = planes_breaker(rzip, seed, dev)
        out["admission_fault"] = planes_admission_fault(lm, reqs, answers,
                                                        dev)
        out["lifecycle"] = planes_lifecycle(lm, reqs, answers, tmp, dev)
    finally:
        eng.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def planes_breaker(zip_path: str, seed: int, dev):
    """(d) On the resilience MLP under ServingChaos: dispatches 2-4 raise
    and walk the breaker open (503 with Retry-After, fast-fails counted);
    after the cooldown the half-open probe closes it; dispatch 6 hangs,
    the watchdog answers it 503 "Wedged" and trips the breaker, and a
    fresh worker answers after the cooldown (the time to recover)."""
    t0 = time.perf_counter()
    chaos = ServingChaos(ServingChaosConfig(
        infer_raise_at=2, infer_raise_count=3, infer_hang_at=6,
        infer_hang_s=120.0))
    eng = ServingEngine(model_path=zip_path, input_shape=(RESIL_MLP[0],),
                        breaker_fails=3, breaker_cooldown_s=PLANES_COOLDOWN_S,
                        watchdog_s=PLANES_WATCHDOG_S, max_wait_ms=1,
                        chaos=chaos, device=dev).start()
    try:
        eng.registry.warmup(max_batch=4)
        row = {"record": np.linspace(-1, 1, RESIL_MLP[0]).tolist()}
        _ok(_call(eng.url, "/predict", row), "dispatch 1")
        for k in (2, 3, 4):
            _error(_call(eng.url, "/predict", row), 400,
                   "InjectedServingFault", f"dispatch {k}")
        hdr = _error(_call(eng.url, "/predict", row), 503, "breaker open",
                     "the open breaker")
        check(int(hdr["Retry-After"]) >= 1, f"Retry-After {hdr}")
        s = eng.stats.snapshot()
        check(s["breaker_opens"] == 1 and s["fast_fails_503"] >= 1,
              f"breaker counters {s}")
        time.sleep(PLANES_COOLDOWN_S + 0.1)
        _ok(_call(eng.url, "/predict", row), "the half-open probe")
        s = eng.stats.snapshot()
        check(s["breaker_closes"] == 1 and s["breaker_probes"] == 1
              and eng.model_health()["default@v1"] == "serving",
              f"the probe did not close the breaker: {s}")
        t_hang = time.perf_counter()
        _error(_call(eng.url, "/predict", row), 503, "Wedged",
               "the hung dispatch")
        t_wedged = time.perf_counter()
        check(eng.model_health()["default@v1"] == "broken",
              "the watchdog's verdict did not trip the breaker")
        s_wedged = eng.stats.snapshot()
        status = None
        while status != 200 and time.perf_counter() - t_wedged < 30:
            time.sleep(0.05)
            status, _, body = _call(eng.url, "/predict", row)
        t_back = time.perf_counter()
        check(status == 200, "no fresh worker answered after the hang")
        s = eng.stats.snapshot()
        check(s["wedged_batches"] == 1 and s["watchdog_restarts"] == 1,
              f"watchdog counters {s}")
        chaos.release_hangs()
        time.sleep(0.5)
        late = eng.stats.snapshot()
        check(late["completed"] == s["completed"]
              and late["batches"] == s["batches"],
              "the hung call's late return changed the counters")
        res = {"diagnosis_s": t_wedged - t_hang,
               "recover_s": t_back - t_wedged,
               "watchdog_s": PLANES_WATCHDOG_S,
               "cooldown_s": PLANES_COOLDOWN_S,
               "fast_fails_503": s["fast_fails_503"],
               "wedged_at": s_wedged["wedged_batches"],
               "chaos": [list(map(str, e)) for e in chaos.log]}
        print(f"breaker: opened after 3 injected failures (503, Retry-After "
              f"{hdr['Retry-After']}), probe closed it; watchdog: the hang "
              f"answered 503 Wedged in {res['diagnosis_s']:.3f} s "
              f"(watchdog {PLANES_WATCHDOG_S} s), a fresh worker answered "
              f"{res['recover_s']:.3f} s later (cooldown "
              f"{PLANES_COOLDOWN_S} s); the late return changed nothing; "
              f"{time.perf_counter() - t0:.1f} s")
        return res
    finally:
        chaos.release_hangs()
        eng.stop(drain=False)


def planes_admission_fault(lm: TransformerLM, reqs, answers, dev):
    """(d) The burst's greedy requests on the bench transformer with the
    third decode admission faulted: only that lane is evicted, every
    other transcript is byte-equal to the serve burst's, K4 and K6 ran
    and their plain versions never."""
    t0 = time.perf_counter()
    chaos = ServingChaos(ServingChaosConfig(admit_raise_at=3))
    eng = ServingEngine(lm, kv_blocks=1024, chaos=chaos, device=dev)
    greedy = [i for i, r in enumerate(reqs) if r["temperature"] == 0.0]
    try:
        d = eng.decoder
        zero_counts()
        futs = [d.submit(np.asarray(reqs[i]["tokens"][0], np.int32),
                         reqs[i]["n_new"], temperature=0.0) for i in greedy]
        got = []
        for f in futs:
            try:
                got.append(np.asarray(f.result(timeout=600)).reshape(-1)
                           .tolist())
            except InjectedServingFault as e:
                got.append(e)
        counts = counts_now()
        crashes = eng.stats.snapshot()["slot_crashes"]
    finally:
        eng.stop()
    check(isinstance(got[2], InjectedServingFault) and crashes == 1,
          f"the third admission did not fault alone ({crashes} crashes)")
    same = sum(1 for j, i in enumerate(greedy) if j != 2
               and got[j] == answers[i])
    print(f"admission fault: admission 3 evicted alone; {same}/"
          f"{len(greedy) - 1} co-resident greedy transcripts byte-equal to "
          f"the serve burst's; launches {counts}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(same == len(greedy) - 1,
          "a co-resident transcript moved under the admission fault")
    check(counts["flash_attention"] > 0 and counts["paged_attention"] > 0
          and counts["flash_attention_plain"] == 0
          and counts["paged_attention_plain"] == 0,
          f"the faulted burst's kernels {counts}")
    return {"equal": same, "of": len(greedy) - 1, "launches": counts}


def planes_lifecycle(lm: TransformerLM, reqs, answers, tmp: str, dev):
    """(e) The bench transformer's zip through POST /models: v1 and v2
    loaded, warmed and served, /generate on v2 and on v1 by version
    (greedy answers equal to the serve burst's; K4 and K6 launched, no
    plain version), v1 unloaded (device memory falls by at least its
    resident bytes), a drain with a stream in flight (the stream ends,
    new requests 503, /health?ready=1 not ready), and a Prometheus
    scrape equal to the JSON /metrics."""
    t0 = time.perf_counter()
    path = os.path.join(tmp, "lm.zip")
    write_lm_zip(path, lm)
    zip_s = time.perf_counter() - t0
    eng = ServingEngine(kv_blocks=1024, device=dev).start()
    try:
        t1 = time.perf_counter()
        for v in (1, 2):
            _ok(_call(eng.url, "/models", {"action": "load", "name": "lm",
                                           "path": path}), f"load lm v{v}")
            _ok(_call(eng.url, "/models", {"action": "warmup", "name": "lm",
                                           "version": v, "gen_tokens": 2}),
                f"warmup lm v{v}")
            d = _ok(_call(eng.url, "/models", {"action": "serve",
                                               "name": "lm",
                                               "version": v}),
                    f"serve lm v{v}")
        check(d["prior_default"] == "lm@v1", f"serve v2: {d}")
        lifecycle_s = time.perf_counter() - t1
        greedy = [i for i, r in enumerate(reqs)
                  if r["temperature"] == 0.0][:2]
        zero_counts()
        for version in (None, 1):
            for i in greedy:
                p = dict(reqs[i])
                if version is not None:
                    p.update(model="lm", version=version)
                got = _ok(_call(eng.url, "/generate", p),
                          "/generate")["tokens"][0]
                check(got == answers[i],
                      f"/generate on lm v{version or 2} != the burst")
        counts = counts_now()
        check(counts["flash_attention"] > 0 and counts["paged_attention"] > 0
              and counts["flash_attention_plain"] == 0
              and counts["paged_attention_plain"] == 0,
              f"/generate on the loaded records: {counts}")
        hbm = eng.hbm_report()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        _ok(_call(eng.url, "/models", {"action": "unload", "name": "lm",
                                       "version": 1}), "unload lm v1")
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        hbm2 = eng.hbm_report()
        freed_params = (hbm["models"]["lm"]["param_bytes"]
                        - hbm2["models"]["lm"]["param_bytes"])
        freed_kv = (hbm["models"]["lm"]["kv_bytes"]
                    - hbm2["models"]["lm"]["kv_bytes"])
        print(f"lifecycle: lm v1 and v2 loaded, warmed, served in "
              f"{lifecycle_s:.1f} s (zip written in {zip_s:.1f} s); "
              f"/generate on v2 and v1 equal to the burst; launches "
              f"{counts}; unload v1: memory_allocated fell "
              f"{(before - after) / 2**20:.1f} MiB, its param_bytes "
              f"{freed_params / 2**20:.1f} MiB, kv_bytes "
              f"{freed_kv / 2**20:.1f} MiB")
        check(before - after >= freed_params > 0,
              "unloading v1 freed less device memory than its param_bytes")
        # drain with a stream in flight
        stream_req = dict(reqs[1], stream=True)
        first, lines, ends = threading.Event(), [], {}

        def stream():
            req = urllib.request.Request(
                eng.url + "/generate", data=json.dumps(stream_req).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                for line in r:
                    lines.append(json.loads(line))
                    first.set()
            ends["stream"] = time.perf_counter()

        ts = threading.Thread(target=stream)
        ts.start()
        check(first.wait(120), "the stream sent no first token")
        td = threading.Thread(target=lambda: ends.update(
            ok=eng.drain(60.0), drain=time.perf_counter()))
        t_drain = time.perf_counter()
        at_drain = len(lines)  # tokens the client had when it began
        td.start()
        while not eng.draining:
            time.sleep(0.001)
        retry = _error(_call(eng.url, "/generate", reqs[0]), 503,
                       "draining", "/generate while draining")
        check(int(retry["Retry-After"]) >= 1, f"Retry-After {retry}")
        st, _, body = _call(eng.url, "/health?ready=1")
        ready = json.loads(body)
        check(st == 503 and ready["live"] and not ready["ready"],
              f"/health?ready=1 while draining: {st} {ready}")
        check(_call(eng.url, "/health")[0] == 503, "/health while draining")
        td.join()
        ts.join()
        toks = [x["token"] for x in lines[:-1]]
        check(ends["ok"] and at_drain < len(toks),
              f"drain {ends['ok']}: the stream was not in flight "
              f"({at_drain} of {len(toks)} tokens when it began)")
        check(lines[-1].get("done") and toks == answers[-1],
              "the stream in flight did not finish with its tokens")
        drain_s = ends["drain"] - t_drain
        # the Prometheus scrape against the JSON /metrics, quiescent
        snap = _ok(_call(eng.url, "/metrics"), "/metrics")["serving"]
        st, hdr, text = _call(eng.url, "/metrics",
                              headers={"Accept": "text/plain"})
        check(st == 200 and hdr["Content-Type"]
              == obs_registry.PROMETHEUS_CONTENT_TYPE, f"scrape {st} {hdr}")
        owner = obs_registry.default_registry()._owner_labels[id(eng)]
        prom = prometheus_samples(text, owner)
        want = flat_numbers("", snap, {})
        diff = {k: (v, prom.get(k)) for k, v in want.items()
                if prom.get(k) != v}
        check(not diff and len(want) > 20,
              f"Prometheus != JSON /metrics: {diff}")
        print(f"drain: a stream in flight ({at_drain} of {len(toks)} "
              f"tokens out when it began) ended with all of them, new "
              f"/generate 503 (Retry-After {retry['Retry-After']}), "
              f"/health?ready=1 live but not ready; drain wall "
              f"{drain_s:.3f} s; Prometheus scrape == JSON /metrics on "
              f"{len(want)} serving samples; "
              f"{time.perf_counter() - t0:.1f} s")
        return {"lifecycle_s": lifecycle_s, "zip_s": zip_s,
                "launches": counts,
                "memory_fell_bytes": before - after,
                "param_bytes": freed_params, "kv_bytes": freed_kv,
                "drain_s": drain_s, "stream_tokens_at_drain": at_drain,
                "prometheus_samples": len(want)}
    finally:
        eng.stop(drain=False)


# ---------------------------------------------------------------------------
# 14. the CNN and layer-zoo MultiLayerNetworks
# ---------------------------------------------------------------------------


def cpu_twin(net: MultiLayerNetwork) -> MultiLayerNetwork:
    """The same network on the CPU: the card's params, states and updater
    state copied over (no fresh init)."""
    cpu = MultiLayerNetwork(copy.deepcopy(net.conf), device="cpu")
    cpu._input_shape = net._input_shape
    to_cpu = lambda t: lowprec.tree_map(lambda a: a.to("cpu", copy=True), t)
    cpu.params, cpu.states = to_cpu(net.params), to_cpu(net.states)
    cpu.updater_state = to_cpu(net.updater_state)
    cpu.iteration = net.iteration
    return cpu


def tree_rel_err(got, want) -> float:
    """The largest error of any leaf of a tree, relative to the tree's
    largest entry."""
    pairs = [(a.cpu().double(), b.cpu().double()) for a, b in
             zip(lowprec.tree_leaves(got), lowprec.tree_leaves(want))
             if b.numel()]
    if not pairs:
        return 0.0
    return (max((a - b).abs().max().item() for a, b in pairs)
            / max(max(b.abs().max().item() for _, b in pairs), 1e-30))


def layer_rel_err(got, want) -> float:
    """The largest error over a network's layers, each relative to its
    layer's largest entry (a bias ahead of BatchNormalization gets a
    gradient of rounding noise only, so its own largest entry is no
    scale)."""
    return max((tree_rel_err(a, b) for a, b in zip(got, want)),
               default=0.0)


def net_logits(net: MultiLayerNetwork, x) -> torch.Tensor:
    """The output layer's pre-activation in inference."""
    with torch.inference_mode():
        x = net._as_input(x)
        last = len(net.layers) - 1
        acts, _ = net._forward(net.params, net.states, x, upto=last)
        h = net._apply_preprocessor(last, acts[-1], x.shape[0])
        return net.layers[-1].preout(net.params[-1], h)


def wall_ms(fn, n: int) -> float:
    """Host wall per call of ``n`` calls, the card drained before and
    after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def cnn_group(name: str) -> str:
    low = name.lower()
    if "lstm_fwd_cluster" in name:
        return "K1 lstm_fwd_cluster"
    if "lstm_bwd_" in name:
        return "K2 lstm_bwd_*"
    if "pool" in low:
        return "pooling"
    if "nhwctonchw" in low or "nchwtonhwc" in low:
        return "conv layout transposes"
    if "fft" in low or "cf32" in low or "complex" in low:
        return "conv by FFT (forward or backward)"
    if "dgrad" in low or "wgrad" in low:
        return "conv backward"
    if any(k in low for k in ("fprop", "conv", "implicit", "winograd")):
        return "conv forward"
    if any(k in low for k in ("gemm", "xmma", "nvjet", "cutlass")):
        return "GEMMs"
    if "foreach" in low or "multi_tensor" in low:
        return "updater (foreach)"
    return "other kernels"


def cnn_profile(fn, step_ms: float, n: int = 3) -> dict:
    """One step's kernels by group (torch.profiler), and the host gaps."""
    busy, rows = profile_ms(fn, n=n)
    groups = {g: 0.0 for g in ("conv forward", "conv backward",
                               "conv by FFT (forward or backward)",
                               "conv layout transposes", "pooling",
                               "GEMMs", "updater (foreach)",
                               "other kernels")}
    for ms_, _, name in rows:
        g = cnn_group(name)
        groups[g] = groups.get(g, 0.0) + ms_
    groups["host gaps (wall - kernels)"] = step_ms - busy
    print(f"  profile: {busy:.3f} ms of kernels a step ({busy / step_ms:.1%}"
          f" of {step_ms:.3f} ms): " + ", ".join(
              f"{k} {v:.3f}" for k, v in groups.items()))
    for ms_, calls, name in rows[:8]:
        print(f"  {ms_:8.4f} ms  x{calls:<3d} {name[:100]}")
    return dict(device_busy_ms=busy, groups=groups,
                kernels=[dict(ms=r[0], calls=r[1], name=r[2][:120])
                         for r in rows[:12]])


def train_flops(net: MultiLayerNetwork, batch: int) -> float:
    """A training step's operations in the convolutions and dense
    products, from the configuration's shapes: 2 per multiply-add, the
    forward and the backward's weight and input gradients (none for the
    first layer's input)."""
    shape, macs, first = tuple(net._input_shape), 0, None
    conf = net.conf
    for i, lc in enumerate(conf.layers):
        pp = conf.input_preprocessors.get(i)
        if pp is not None:
            shape = pp.out_shape(shape)
        n = 0
        if isinstance(lc, (nn_conf.ConvolutionLayer,
                           nn_conf.SubsamplingLayer)):
            h, w, c = shape
            (kh, kw), (sh, sw), (ph, pw) = (lc.kernel_size, lc.stride,
                                            lc.padding)
            oh, ow = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
            if isinstance(lc, nn_conf.ConvolutionLayer):
                n = oh * ow * lc.n_out * kh * kw * c
                c = lc.n_out
            shape = (oh, ow, c)
        elif isinstance(lc, (nn_conf.DenseLayer, nn_conf.OutputLayer)):
            n = shape[-1] * lc.n_out
            shape = (lc.n_out,)
        if first is None and n:
            first = n
        macs += n
    return 2.0 * batch * (3 * macs - (first or 0))


def phase_lenet(seed: int, dev) -> dict:
    print("== (a) LeNet-5 MNIST training at bench.py's protocol (batch "
          f"{LENET_BATCH}, {LENET_FITS} fits, then fit_batches of "
          f"K={LENET_K} x {LENET_REPS}) ==")
    b = LENET_BATCH
    net = build_lenet5(device=dev)
    x, y, prov = load_mnist_info(train=True, num_examples=b * 4)
    xs = [torch.from_numpy(x[i * b:(i + 1) * b]).to(dev) for i in range(4)]
    ys = [torch.from_numpy(y[i * b:(i + 1) * b]).to(dev) for i in range(4)]
    cpu = cpu_twin(net)
    first = float(net.fit(xs[0], ys[0]))
    want = float(cpu.fit(x[:b], y[:b]))
    loss_err = abs(first - want) / abs(want)
    param_err = layer_rel_err(lowprec.tree_leaves(net.params),
                              lowprec.tree_leaves(cpu.params))
    del cpu
    print(f"LeNet-5 ({net.num_params()} parameters), data {prov}; the first "
          f"step on the card against the CPU: loss {first:.6f} vs "
          f"{want:.6f} (rel {loss_err:.2e}), params {param_err:.2e} of each "
          f"leaf's largest entry (tol {TOL_CARD_CPU})")
    check(loss_err <= TOL_CARD_CPU and param_err <= TOL_CARD_CPU,
          "LeNet-5's first step on the card disagrees with the CPU's")
    i = [1]

    def step():
        loss = net.fit(xs[i[0] % 4], ys[i[0] % 4])
        i[0] += 1
        return loss

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step() for _ in range(LENET_FITS)]
    last = float(losses[-1])  # the readback ends the timed region
    fit_ms = (time.perf_counter() - t0) / LENET_FITS * 1e3
    fit_sps = b / fit_ms * 1e3
    big_x = torch.stack([xs[k % 4] for k in range(LENET_K)])
    big_y = torch.stack([ys[k % 4] for k in range(LENET_K)])
    net.fit_batches(big_x, big_y)  # warm, as bench.py does
    t0 = time.perf_counter()
    fused = [net.fit_batches(big_x, big_y) for _ in range(LENET_REPS)]
    fused_ms = (time.perf_counter() - t0) / (LENET_K * LENET_REPS) * 1e3
    fused_sps = b / fused_ms * 1e3
    flops = train_flops(net, b)
    print(f"fit: {fit_ms:.3f} ms a step, {fit_sps:.1f} samples/s; "
          f"fit_batches: {fused_ms:.3f} ms a step, {fused_sps:.1f} "
          f"samples/s; {flops / 1e9:.2f} GFLOP a step ({flops / fit_ms / 1e9:.2f}"
          f" TFLOP/s in fit; f32 bound {flops / PEAK_F32_FLOPS * 1e3:.4f} ms)")
    tail = float(np.mean(fused[-1][-8:]))
    print(f"loss: first step {first:.4f}, after the 30 fits {last:.4f}, "
          f"the last fit_batches' last 8 steps {tail:.4f}")
    check(all(np.isfinite(f).all() for f in fused) and np.isfinite(last),
          "a LeNet-5 loss is not finite")
    check(tail < first, "LeNet-5's loss did not fall")
    prof = cnn_profile(step, fit_ms)
    return dict(data=prov, params=net.num_params(), batch=b,
                first_step_loss_rel_err=loss_err,
                first_step_param_err=param_err, fit_ms=fit_ms,
                fit_samples_per_s=fit_sps, fit_batches_ms=fused_ms,
                fit_batches_samples_per_s=fused_sps,
                gflop_per_step=flops / 1e9, loss_first=first,
                loss_after_fits=last, loss_tail=tail, profile=prof)


def phase_big_cnns(seed: int, dev) -> dict:
    print("== (b) AlexNet at 227 and VGG16 at 224, strict f32 ==")
    rng = np.random.default_rng(seed + 20)
    out = {}
    for name, build, size, batch, steps in (
            ("alexnet", build_alexnet, ALEX_SIZE, ALEX_BATCH, ALEX_STEPS),
            ("vgg16", build_vgg16, VGG_SIZE, VGG_BATCH, VGG_STEPS)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        net = build(input_size=size, device=dev)
        x2 = rng.random((2, size, size, 3), dtype=np.float32)
        cpu = cpu_twin(net)
        got, want = net_logits(net, x2).cpu(), net_logits(cpu, x2)
        err = ((got - want).abs().max() / want.abs().max()).item()
        del cpu
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.rand((batch, size, size, 3), generator=gen, device=dev)
        y = F.one_hot(torch.randint(0, 1000, (batch,), generator=gen,
                                    device=dev), 1000).float()
        rec = dict(params=net.num_params(), batch=batch,
                   logits_rel_err_batch2=err)
        if name == "alexnet":
            net.output(x[:ALEX_OUT_BATCH])
            out_ms = wall_ms(lambda: net.output(x[:ALEX_OUT_BATCH]), 5)
            rec.update(output_ms=out_ms,
                       output_images_per_s=ALEX_OUT_BATCH / out_ms * 1e3)
        losses, step_ms = [], []
        for _ in range(steps):
            step_ms.append(wall_ms(lambda: losses.append(
                float(net.fit(x, y))), 1))
        ms = float(np.mean(step_ms[1:]))
        peak = torch.cuda.max_memory_allocated() - held
        flops = train_flops(net, batch)
        rec.update(step_ms=ms, first_step_ms=step_ms[0],
                   images_per_s=batch / ms * 1e3, losses=losses,
                   peak_bytes=peak, gflop_per_step=flops / 1e9,
                   bound_ms=flops / PEAK_F32_FLOPS * 1e3)
        print(f"{name}: {rec['params']} parameters; batch-2 logits on the "
              f"card within {err:.2e} of the CPU's largest (tol "
              f"{TOL_CARD_CPU}); " + (
                  f"output at batch {ALEX_OUT_BATCH} {rec['output_ms']:.3f} "
                  f"ms ({rec['output_images_per_s']:.1f} images/s); "
                  if name == "alexnet" else "")
              + f"{steps} steps at batch {batch}: {ms:.3f} ms a step after "
              f"the first ({step_ms[0]:.1f}), {rec['images_per_s']:.1f} "
              f"images/s, {flops / 1e9:.1f} GFLOP a step "
              f"({flops / ms / 1e9:.2f} TFLOP/s; f32 bound "
              f"{rec['bound_ms']:.3f} ms); losses "
              + " ".join(f"{v:.4f}" for v in losses)
              + f"; peak {peak / 2**30:.3f} GiB above what was held")
        check(err <= TOL_CARD_CPU,
              f"{name}'s logits on the card disagree with the CPU's")
        check(all(np.isfinite(losses)), f"a {name} loss is not finite")
        rec["profile"] = cnn_profile(lambda: net.fit(x, y), ms, n=2)
        out[name] = rec
        del net, x, y
    torch.cuda.empty_cache()
    return out


def phase_pretrain(seed: int, dev) -> dict:
    print(f"== (c) pretraining: the DBN and the stacked denoising "
          f"autoencoder, {PRE_BATCHES} batches of {PRE_BATCH}, then "
          f"{PRE_FINETUNE} fine-tune steps ==")
    n = PRE_BATCH * PRE_BATCHES
    x, y, prov = load_mnist_info(train=True, num_examples=n, binarize=True)
    x = x.reshape(n, -1)
    out = {}
    for name, build in (("dbn", build_dbn),
                        ("stacked_autoencoder", build_stacked_autoencoder)):
        net = build(device=dev)
        init = lowprec.tree_map(torch.clone, net.params)
        n_pre = sum(1 for lc in net.conf.layers
                    if isinstance(lc, (nn_conf.RBM, nn_conf.AutoEncoder)))
        pre_ms = wall_ms(lambda: net.pretrain(
            ListDataSetIterator(x, y, batch=PRE_BATCH)), 1)
        xt = torch.from_numpy(x).to(dev)
        acts = net.feed_forward(xt)  # each layer's input, the ones before
        recon = []                   # it pretrained (as its pretraining saw)
        with torch.no_grad():
            for i in range(n_pre):
                layer = net.layers[i]
                pair = [float(layer.pretrain_loss(
                    p[i], acts[i],
                    torch.Generator(device=dev).manual_seed(seed)))
                    for p in (init, net.params)]
                recon.append(pair)
        fine = [float(net.fit(xt[(k % PRE_BATCHES) * PRE_BATCH:
                                 (k % PRE_BATCHES + 1) * PRE_BATCH],
                              torch.from_numpy(
                                  y[(k % PRE_BATCHES) * PRE_BATCH:
                                    (k % PRE_BATCHES + 1) * PRE_BATCH]
                              ).to(dev)))
                for k in range(PRE_FINETUNE)]
        print(f"{name} ({net.num_params()} parameters, data {prov}): "
              f"pretraining {n_pre} layers x {PRE_BATCHES} batches in "
              f"{pre_ms:.1f} ms ({pre_ms / (n_pre * PRE_BATCHES):.3f} ms a "
              "step); reconstruction loss per layer, before -> after its "
              "pretraining: " + ", ".join(
                  f"{i}: {a:.3f} -> {b:.3f}" for i, (a, b) in
                  enumerate(recon))
              + "; fine-tune losses " + " ".join(f"{v:.4f}" for v in fine))
        check(all(b < a for a, b in recon),
              f"a {name} layer's reconstruction loss did not fall")
        check(all(np.isfinite(fine)) and np.mean(fine[-3:]) < fine[0],
              f"{name}'s fine-tune loss did not fall")
        out[name] = dict(params=net.num_params(), pretrain_ms=pre_ms,
                         reconstruction=recon, finetune_losses=fine,
                         data=prov)
    return out


def phase_solvers(seed: int, dev) -> dict:
    print(f"== (d) the Solver: LeNet-5 under the line-search family, "
          f"iterations={SOLVER_ITERS}, batch {LENET_BATCH} ==")
    x, y, _ = load_mnist_info(train=True, num_examples=LENET_BATCH)
    x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    out = {}
    for algo in ("line_gradient_descent", "conjugate_gradient", "lbfgs"):
        conf = lenet5_conf()
        conf.optimization_algo, conf.iterations = algo, SOLVER_ITERS
        net = MultiLayerNetwork(conf, device=dev).init(
            input_shape=LENET_INPUT)
        before = net.score(x, y)
        res = {}
        ms = wall_ms(lambda: res.setdefault("loss", float(net.fit(x, y))),
                     1)
        iters = net.iteration
        print(f"{algo}: score {before:.4f} -> {res['loss']:.4f} in {iters} "
              f"iterations, {ms / max(iters, 1):.3f} ms an iteration")
        check(np.isfinite(res["loss"]) and res["loss"] < before,
              f"{algo} did not lower LeNet-5's score")
        out[algo] = dict(score_before=before, score_after=res["loss"],
                         iterations=iters, ms=ms,
                         ms_per_iteration=ms / max(iters, 1))
    return out


def embedding_lstm_conf(seed: int):
    """EmbeddingLayer(VOCAB -> LSTM_H) -> GravesLSTM(LSTM_H, tanh) ->
    RnnOutputLayer(VOCAB): the char-RNN's widths; a reshape gives the LSTM
    its [SEQ, LSTM_H] input shape at init."""
    return (NeuralNetConfiguration.builder().seed(seed)
            .learning_rate(TRAIN_LR).updater("rmsprop").list()
            .layer(0, nn_conf.EmbeddingLayer(n_in=VOCAB, n_out=LSTM_H,
                                             activation="identity"))
            .layer(1, nn_conf.GravesLSTM(n_in=LSTM_H, n_out=LSTM_H,
                                         activation="tanh"))
            .layer(2, nn_conf.RnnOutputLayer(n_in=LSTM_H, n_out=VOCAB,
                                             activation="softmax",
                                             loss_function="mcxent"))
            .input_preprocessor(1, ReshapePreProcessor((SEQ, LSTM_H)))
            .build())


def zoo_confs(seed: int):
    """(name, conf, input shape, features, labels, mask) of the CNN zoo
    (conv, BN on NHWC, Activation, LRN, avg pooling, dense, BN,
    Activation) and the RNN zoo (GRU, bidirectional LSTM, masked)."""
    rng = np.random.default_rng(seed + 30)
    b = lambda upd: (NeuralNetConfiguration.builder().seed(seed)
                     .learning_rate(0.01).updater(upd).momentum(0.9)
                     .l2(1e-4).list())
    cnn = (b("nesterovs")
           .layer(0, nn_conf.ConvolutionLayer(
               n_in=3, n_out=16, kernel_size=(3, 3), padding=(1, 1),
               activation="identity"))
           .layer(1, nn_conf.BatchNormalization(n_out=16))
           .layer(2, nn_conf.ActivationLayer(activation="relu"))
           .layer(3, nn_conf.LocalResponseNormalization())
           .layer(4, nn_conf.SubsamplingLayer(pooling_type="avg"))
           .layer(5, nn_conf.DenseLayer(n_in=16 * 16 * 16, n_out=64,
                                        activation="identity"))
           .layer(6, nn_conf.BatchNormalization(n_out=64))
           .layer(7, nn_conf.ActivationLayer(activation="tanh"))
           .layer(8, nn_conf.OutputLayer(n_in=64, n_out=10,
                                         activation="softmax"))
           .input_preprocessor(5, CnnToFeedForwardPreProcessor(16, 16, 16))
           .build())
    rnn = (b("adagrad")
           .layer(0, nn_conf.GRU(n_in=32, n_out=64, activation="tanh"))
           .layer(1, nn_conf.GravesBidirectionalLSTM(n_in=64, n_out=64,
                                                     activation="tanh"))
           .layer(2, nn_conf.RnnOutputLayer(n_in=64, n_out=10,
                                            activation="softmax"))
           .build())
    mask = np.ones((8, 20), np.float32)
    mask[1, 12:] = 0
    mask[5, 3:] = 0
    return [("cnn_zoo", cnn, (32, 32, 3),
             rng.normal(size=(16, 32, 32, 3)).astype(np.float32),
             np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)], None),
            ("rnn_zoo", rnn, (20, 32),
             rng.normal(size=(8, 20, 32)).astype(np.float32),
             np.eye(10, dtype=np.float32)[rng.integers(0, 10, (8, 20))],
             mask)]


def phase_zoo(seed: int, dev):
    print(f"== (e) the layer zoo: Embedding({VOCAB} -> {LSTM_H}) -> "
          f"GravesLSTM({LSTM_H}) -> RnnOutputLayer({VOCAB}), "
          f"{ZOO_FITS} fits at {TRAIN_BATCH} x {SEQ}; the CNN and RNN zoos "
          "against the CPU ==")
    net = MultiLayerNetwork(embedding_lstm_conf(seed), device=dev).init(
        input_shape=(SEQ,))
    ids = markov_tokens(seed + 31, (TRAIN_BATCH, SEQ + 1), VOCAB)
    x = torch.from_numpy(ids[:, :-1]).to(dev)
    y = torch.from_numpy(np.eye(VOCAB, dtype=np.float32)[ids[:, 1:]]).to(dev)
    net.fit(x, y)  # warm
    kernels = (lstm_scan, lstm_scan_plain, lstm_scan_bwd,
               lstm_scan_bwd_plain)
    for fn in kernels:
        fn.launches = 0
    losses = []
    ms = wall_ms(lambda: losses.append(net.fit(x, y)), ZOO_FITS)
    counts = {fn.__name__: fn.launches for fn in kernels}
    losses = [float(v) for v in losses]
    print(f"Embedding-LSTM: {ms:.3f} ms a fit, "
          f"{TRAIN_BATCH * SEQ / ms * 1e3:.0f} tokens/s; losses "
          + " ".join(f"{v:.4f}" for v in losses) + f"; launches {counts}")
    check(counts["lstm_scan"] == counts["lstm_scan_bwd"] == ZOO_FITS,
          "K1 and K2 did not launch once per Embedding-LSTM fit")
    check(counts["lstm_scan_plain"] == counts["lstm_scan_bwd_plain"] == 0,
          "a plain LSTM scan ran in the Embedding-LSTM fits")
    check(all(np.isfinite(losses)) and np.mean(losses[-3:]) < losses[0],
          "the Embedding-LSTM loss did not fall")
    prof = cnn_profile(lambda: net.fit(x, y), ms)
    out = dict(fit_ms=ms, tokens_per_s=TRAIN_BATCH * SEQ / ms * 1e3,
               losses=losses, launches=counts, profile=prof)
    del net
    for name, conf, shape, xz, yz, mz in zoo_confs(seed):
        znet = MultiLayerNetwork(conf, device=dev).init(input_shape=shape)
        cpu = cpu_twin(znet)
        got = float(znet.fit(xz, yz, mz))
        want = float(cpu.fit(xz, yz, mz))
        loss_err = abs(got - want) / abs(want)
        p_err = layer_rel_err(znet.params, cpu.params)
        s_err = layer_rel_err(znet.states, cpu.states)
        o_err = tree_rel_err(znet.output(xz), cpu.output(xz))
        print(f"{name}: one fit and output, card against CPU: loss rel "
              f"{loss_err:.2e}, params {p_err:.2e}, states {s_err:.2e}, "
              f"output {o_err:.2e} (of each layer's, and the output's, "
              f"largest entry; tol {TOL_CARD_CPU})")
        check(max(loss_err, p_err, s_err, o_err) <= TOL_CARD_CPU,
              f"the {name} net on the card disagrees with the CPU")
        out[name] = dict(loss_rel_err=loss_err, param_err=p_err,
                         state_err=s_err, output_err=o_err)
    return counts, out


def phase_cnn_zoo(seed: int, dev):
    """(K1/K2 launches of path (e), the report of (a)-(e))."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep = {"lenet5": phase_lenet(seed, dev),
           "big_cnns": phase_big_cnns(seed, dev),
           "pretrain": phase_pretrain(seed, dev),
           "solvers": phase_solvers(seed, dev)}
    counts, rep["zoo"] = phase_zoo(seed, dev)
    rep["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    rep["wall_s"] = time.perf_counter() - t0
    print(f"the CNN and layer-zoo phase: {rep['wall_s']:.1f} s")
    return counts, rep


# ---------------------------------------------------------------------------
# the ComputationGraph: ResNet-50, GoogLeNet, a seq2seq graph through K1/K2,
# bf16 loss-scaled steps; then /embed
# ---------------------------------------------------------------------------


def graph_train_flops(net: ComputationGraph, batch: int) -> float:
    """A training step's operations in a graph's convolutions and dense
    products, from the configuration's shapes, vertex by vertex: 2 per
    multiply-add, the forward and the backward's weight and input
    gradients (no input gradient for a layer fed by a graph input)."""
    vshape = {k: tuple(v) for k, v in net._input_shapes.items()}
    macs = first = 0
    for name in net.topo:
        v = net.conf.vertices[name]
        ins = net.conf.vertex_inputs[name]
        in_shapes = [vshape[i] for i in ins]
        if not isinstance(v, L.Layer):
            vshape[name] = net._vertex_out_shape(v, name, in_shapes)
            continue
        shape = in_shapes[0]
        pp = net.conf.input_preprocessors.get(name)
        if pp is not None:
            shape = pp.out_shape(shape)
        n = 0
        if isinstance(v, (L.ConvolutionLayer, L.SubsamplingLayer)):
            h, w, c = shape
            (kh, kw), (sh, sw), (ph, pw) = v.kernel_size, v.stride, v.padding
            oh, ow = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
            if isinstance(v, L.ConvolutionLayer):
                n = oh * ow * v.n_out * kh * kw * c
                c = v.n_out
            shape = (oh, ow, c)
        elif isinstance(v, (L.DenseLayer, L.OutputLayer)):
            n = shape[-1] * v.n_out
            shape = (v.n_out,)
        vshape[name] = shape
        macs += n
        if any(i in net.conf.inputs for i in ins):
            first += n
    return 2.0 * batch * (3 * macs - first)


def graph_cpu_twin(net: ComputationGraph, dtype=None) -> ComputationGraph:
    """The same graph on the CPU: the card's params, states and updater
    state copied over (cast to ``dtype`` when given)."""
    cpu = ComputationGraph(copy.deepcopy(net.conf), device="cpu")
    cpu._input_shapes = dict(net._input_shapes)
    to_cpu = lambda t: lowprec.tree_map(
        lambda a: a.to("cpu", dtype=dtype, copy=True), t)
    cpu.params, cpu.states = to_cpu(net.params), to_cpu(net.states)
    cpu.updater_state = to_cpu(net.updater_state)
    cpu.iteration = net.iteration
    return cpu


def vertex_errs(got: dict, want: dict) -> dict:
    """Each layer vertex's largest error relative to its largest entry
    (a bias ahead of BN gets rounding noise only)."""
    return {k: tree_rel_err(got[k], want[k]) for k in want}


def vertex_rel_err(got: dict, want: dict) -> float:
    """The largest of :func:`vertex_errs`."""
    return max(vertex_errs(got, want).values(), default=0.0)


def graph_group(name: str) -> str:
    low = name.lower()
    if "reduce" in low and "conv" not in low:
        return "reductions (BN statistics, l2)"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise (BN, ReLU, residual adds, l2)"
    return cnn_group(name)


def graph_profile(fn, step_ms: float, n: int = 2) -> dict:
    """One step's kernels by group (torch.profiler), and the host gaps."""
    busy, rows = profile_ms(fn, n=n)
    groups: dict = {}
    for ms_, _, name in rows:
        g = graph_group(name)
        groups[g] = groups.get(g, 0.0) + ms_
    groups = dict(sorted(groups.items(), key=lambda kv: -kv[1]))
    groups["host gaps (wall - kernels)"] = step_ms - busy
    print(f"  profile: {busy:.3f} ms of kernels a step ({busy / step_ms:.1%}"
          f" of {step_ms:.3f} ms): " + ", ".join(
              f"{k} {v:.3f}" for k, v in groups.items()))
    for ms_, calls, name in rows[:10]:
        print(f"  {ms_:8.4f} ms  x{calls:<3d} {name[:100]}")
    return dict(device_busy_ms=busy, groups=groups,
                kernels=[dict(ms=r[0], calls=r[1], name=r[2][:120])
                         for r in rows[:16]])


def image_batch(seed: int, n: int, size: int, classes: int, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((n, size, size, 3), generator=gen, device=dev)
    y = F.one_hot(torch.randint(0, classes, (n,), generator=gen,
                                device=dev), classes).float()
    return x, y


def phase_resnet(seed: int, dev) -> dict:
    print(f"== (a) ResNet-50 training at {RESNET_SIZE} x {RESNET_SIZE}, "
          f"1000 classes, batch "
          f"{RESNET_BATCH}, Nesterovs lr {RESNET_LR}, strict f32 "
          f"(bench.py:271-330) ==")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    net = build_resnet50(input_size=RESNET_SIZE, device=dev,
                         learning_rate=RESNET_LR)
    x2, y2 = image_batch(seed + 40, 2, RESNET_SIZE, 1000, "cpu")
    cpu, cpu64 = graph_cpu_twin(net), graph_cpu_twin(net, torch.float64)
    first = float(net.fit(x2.to(dev), y2.to(dev)))
    want = float(cpu.fit(x2, y2))
    want64 = float(cpu64.fit(x2.double(), y2.double()))
    loss_err = abs(first - want) / abs(want)
    # f32 gradients through 53 BN layers of an untrained ResNet at batch 2
    # lose whole digits (the CPU's own f32 step lands percents of a
    # vertex's largest entry from its f64 step): the card's step is held
    # to the f64 step, its worst vertex within F32_NOISE_FACTOR times the
    # CPU's worst (two f32 summation orders, each as far off; vertex by
    # vertex the ratio is noise over a small denominator)
    card_e = vertex_errs(net.params, cpu64.params)
    cpu_e = vertex_errs(cpu.params, cpu64.params)
    worst = max(card_e, key=card_e.get)
    p_err = card_e[worst]
    p_ok = p_err <= F32_NOISE_FACTOR * max(cpu_e.values()) + TOL_CARD_CPU
    s_err = vertex_rel_err(net.states, cpu.states)
    del cpu, cpu64
    print(f"ResNet-50: {net.num_params()} parameters, "
          f"{len(net.layer_names)} layer vertices; the first step at batch 2 "
          f"on the card against the CPU: loss {first:.6f} vs {want:.6f} "
          f"(f64 {want64:.6f}; rel {loss_err:.2e}); params against the f64 "
          f"step: the card {p_err:.2e}, the CPU's f32 "
          f"{max(cpu_e.values()):.2e} of each vertex's largest entry (the "
          f"card's worst vertex {worst}: {card_e[worst]:.2e}, the CPU's there "
          f"{cpu_e[worst]:.2e}; tol {F32_NOISE_FACTOR}x the CPU's worst); BN "
          f"states {s_err:.2e} (tol {TOL_CARD_CPU})")
    check(loss_err <= TOL_CARD_CPU and p_ok and s_err <= TOL_CARD_CPU,
          "ResNet-50's first step on the card disagrees with the CPU's")
    x, y = image_batch(seed + 41, RESNET_BATCH, RESNET_SIZE, 1000, dev)
    losses = [float(net.fit(x, y))]  # warm at the batch
    step_ms = wall_ms(lambda: losses.append(net.fit(x, y)), RESNET_STEPS)
    losses = [float(v) for v in losses]
    peak = torch.cuda.max_memory_allocated() - held
    flops = graph_train_flops(net, RESNET_BATCH)
    rec = dict(params=net.num_params(), batch=RESNET_BATCH,
               first_step_loss_rel_err=loss_err,
               first_step_vertex_errs={k: (card_e[k], cpu_e[k])
                                       for k in card_e},
               first_step_param_err_vs_f64=p_err,
               first_step_cpu_f32_err_vs_f64=max(cpu_e.values()),
               first_step_state_err=s_err, step_ms=step_ms,
               images_per_s=RESNET_BATCH / step_ms * 1e3, losses=losses,
               peak_bytes=peak, gflop_per_step=flops / 1e9,
               bound_ms=flops / PEAK_F32_FLOPS * 1e3,
               tflop_per_s=flops / step_ms / 1e9)
    print(f"ResNet-50: {RESNET_STEPS} steps at batch {RESNET_BATCH}: "
          f"{step_ms:.3f} ms a step, {rec['images_per_s']:.1f} images/s, "
          f"{flops / 1e12:.3f} TFLOP a step from the conf "
          f"({rec['tflop_per_s']:.2f} TFLOP/s; f32 bound "
          f"{rec['bound_ms']:.3f} ms at {PEAK_F32_FLOPS / 1e12:.0f} "
          f"TFLOP/s); losses " + " ".join(f"{v:.4f}" for v in losses)
          + f"; peak {peak / 2**30:.3f} GiB above what was held")
    check(all(np.isfinite(losses)), "a ResNet-50 loss is not finite")
    rec["profile"] = graph_profile(lambda: net.fit(x, y), step_ms)
    return rec, net, (x, y)


def phase_googlenet(seed: int, dev) -> dict:
    print(f"== (b) GoogLeNet with its two auxiliary heads at {GOOG_SIZE}, "
          f"1000 classes, batch {GOOG_BATCH}, {GOOG_STEPS} steps ==")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    net = build_googlenet(input_size=GOOG_SIZE, aux_heads=True, device=dev)
    x, y = image_batch(seed + 42, GOOG_BATCH, GOOG_SIZE, 1000, dev)
    labels = [y] * len(net.conf.outputs)
    outs = net.output(x)
    check([tuple(o.shape) for o in outs] == [(GOOG_BATCH, 1000)] * 3
          and net.conf.outputs[0] == "out",
          "GoogLeNet's output is not three heads with the main one first")
    # the score is the three heads' mcxent summed, plus the l2 penalty
    with torch.no_grad():
        heads = [float(-(y * torch.log(o)).sum(-1).mean()) for o in outs]
        penalty = float(net._regularization_penalty(net.params))
    score = net.score(x, labels)
    sum_err = abs(score - (sum(heads) + penalty)) / abs(score)
    losses = [float(net.fit(x, labels))]
    step_ms = wall_ms(lambda: losses.append(net.fit(x, labels)), GOOG_STEPS)
    losses = [float(v) for v in losses]
    flops = graph_train_flops(net, GOOG_BATCH)
    rec = dict(params=net.num_params(), batch=GOOG_BATCH, step_ms=step_ms,
               images_per_s=GOOG_BATCH / step_ms * 1e3, losses=losses,
               head_losses=heads, penalty=penalty, score=score,
               summed_rel_err=sum_err, gflop_per_step=flops / 1e9,
               bound_ms=flops / PEAK_F32_FLOPS * 1e3)
    print(f"GoogLeNet: {rec['params']} parameters; output heads "
          f"{net.conf.outputs}; score {score:.5f} = heads "
          + " + ".join(f"{h:.5f}" for h in heads)
          + f" + l2 {penalty:.5f} (rel {sum_err:.1e}); {step_ms:.3f} ms a "
          f"step, {rec['images_per_s']:.1f} images/s, {flops / 1e9:.1f} "
          f"GFLOP a step ({flops / step_ms / 1e9:.2f} TFLOP/s); losses "
          + " ".join(f"{v:.4f}" for v in losses))
    check(sum_err <= 1e-4, "GoogLeNet's score is not its heads' sum")
    check(all(np.isfinite(losses)), "a GoogLeNet loss is not finite")
    del net, x, y, labels, outs
    torch.cuda.empty_cache()
    return rec


def seq2seq_conf(seed: int, tbptt=None):
    """The encoder-decoder graph at the char-RNN's widths (bench.py:206):
    GravesLSTM(80 -> 200) encoder -> LastTimeStepVertex ->
    DuplicateToTimeSeriesVertex against the decoder input -> MergeVertex
    with it -> GravesLSTM(280 -> 200) decoder -> RnnOutputLayer(80)."""
    gb = (NeuralNetConfiguration.builder().seed(seed).learning_rate(TRAIN_LR)
          .updater("rmsprop").graph_builder().add_inputs("enc_in", "dec_in")
          .add_layer("enc", L.GravesLSTM(n_in=VOCAB, n_out=LSTM_H,
                                         activation="tanh"), "enc_in")
          .add_vertex("last", graph_conf.LastTimeStepVertex(), "enc")
          .add_vertex("dup", graph_conf.DuplicateToTimeSeriesVertex(
              reference_input="dec_in"), "last")
          .add_vertex("merge", graph_conf.MergeVertex(), "dup", "dec_in")
          .add_layer("dec", L.GravesLSTM(n_in=LSTM_H + VOCAB, n_out=LSTM_H,
                                         activation="tanh"), "merge")
          .add_layer("out", L.RnnOutputLayer(n_in=LSTM_H, n_out=VOCAB,
                                             activation="softmax",
                                             loss_function="mcxent"), "dec")
          .set_outputs("out"))
    if tbptt:
        gb = (gb.backprop_type("truncated_bptt").t_bptt_forward_length(tbptt)
              .t_bptt_backward_length(tbptt))
    return gb.build()


S2S_SHAPES = {"enc_in": (-1, VOCAB), "dec_in": (-1, VOCAB)}
K12 = (lstm_scan, lstm_scan_bwd, lstm_scan_plain, lstm_scan_bwd_plain)


def phase_seq2seq(seed: int, dev):
    print(f"== (c) the seq2seq graph: GravesLSTM({LSTM_H}) encoder -> "
          f"LastTimeStep -> DuplicateToTimeSeries -> Merge -> "
          f"GravesLSTM({LSTM_H}) decoder -> RnnOutputLayer({VOCAB}), "
          f"{S2S_FITS} fits at {TRAIN_BATCH} x {SEQ}, one TBPTT-{TBPTT} fit, "
          "rnn_time_step ==")
    net = ComputationGraph(seq2seq_conf(seed), device=dev).init(S2S_SHAPES)
    eye = np.eye(VOCAB, dtype=np.float32)
    ids = markov_tokens(seed + 50, (TRAIN_BATCH, 2 * SEQ + 1), VOCAB)
    enc = torch.from_numpy(eye[ids[:, :SEQ]]).to(dev)
    dec = torch.from_numpy(eye[ids[:, SEQ:2 * SEQ]]).to(dev)
    y = torch.from_numpy(eye[ids[:, SEQ + 1:]]).to(dev)
    cpu = graph_cpu_twin(net)
    first = float(net.fit([enc, dec], [y]))
    want = float(cpu.fit([enc.cpu(), dec.cpu()], [y.cpu()]))
    loss_err = abs(first - want) / abs(want)
    p_err = vertex_rel_err(net.params, cpu.params)
    del cpu
    print(f"seq2seq: {net.num_params()} parameters; the first fit on the "
          f"card against the CPU: loss {first:.6f} vs {want:.6f} (rel "
          f"{loss_err:.2e}), params {p_err:.2e} of each vertex's largest "
          f"entry (tol {TOL_CARD_CPU})")
    check(max(loss_err, p_err) <= TOL_CARD_CPU,
          "the seq2seq graph's first fit on the card disagrees with the CPU")
    for fn in K12:
        fn.launches = 0
    losses = []
    fit_ms = wall_ms(lambda: losses.append(net.fit([enc, dec], [y])),
                     S2S_FITS)
    counts = {fn.__name__: fn.launches for fn in K12}
    losses = [float(v) for v in losses]
    print(f"seq2seq: {fit_ms:.3f} ms a fit, "
          f"{TRAIN_BATCH * SEQ / fit_ms * 1e3:.0f} decoder tokens/s; losses "
          + " ".join(f"{v:.4f}" for v in losses) + f"; launches {counts}")
    check(counts["lstm_scan"] == counts["lstm_scan_bwd"] == 2 * S2S_FITS,
          "K1 and K2 did not launch twice per seq2seq fit")
    check(counts["lstm_scan_plain"] == counts["lstm_scan_bwd_plain"] == 0,
          "a plain LSTM scan ran in the seq2seq fits")
    check(all(np.isfinite(losses)) and np.mean(losses[-3:]) < first,
          "the seq2seq loss did not fall")
    prof = graph_profile(lambda: net.fit([enc, dec], [y]), fit_ms, n=3)
    tb = ComputationGraph(seq2seq_conf(seed, tbptt=TBPTT),
                          device=dev).init(S2S_SHAPES)
    tb.params = lowprec.tree_map(torch.clone, net.params)
    tb.updater_state = tb.updater.init(tb.params)
    for fn in K12:
        fn.launches = 0
    tb_loss = float(tb.fit([enc, dec], [y]))
    tb_counts = {fn.__name__: fn.launches for fn in K12}
    windows = -(-SEQ // TBPTT)
    carried = float(tb.states["dec"]["h"].abs().max())
    print(f"seq2seq TBPTT-{TBPTT}: {windows} windows, loss {tb_loss:.4f}, "
          f"launches {tb_counts}; the decoder's carried h max |h| "
          f"{carried:.4f}")
    check(tb_counts["lstm_scan"] == tb_counts["lstm_scan_bwd"]
          == 2 * windows and tb_counts["lstm_scan_plain"] == 0,
          "the TBPTT fit did not run K1/K2 twice a window")
    check(np.isfinite(tb_loss) and carried > 0, "the TBPTT fit failed")
    del tb
    (full,) = net.output(enc, dec)
    net.rnn_clear_previous_state()
    for fn in K12:
        fn.launches = 0
    (last,) = net.rnn_time_step(enc, dec)
    step_counts = {fn.__name__: fn.launches for fn in K12}
    rts_err = (last - full[:, -1]).abs().max().item()
    print(f"rnn_time_step over the {SEQ} steps against output's last step: "
          f"{rts_err:.2e} (tol {TOL_LSTM}); launches {step_counts}")
    check(rts_err <= TOL_LSTM and step_counts["lstm_scan"] == 2
          and step_counts["lstm_scan_plain"] == 0,
          "rnn_time_step disagrees with output or missed K1")
    counts = {k: counts[k] + tb_counts[k] + step_counts[k] for k in counts}
    return counts, dict(first_step_loss_rel_err=loss_err,
                        first_step_param_err=p_err, fit_ms=fit_ms,
                        tokens_per_s=TRAIN_BATCH * SEQ / fit_ms * 1e3,
                        losses=losses, launches=counts, tbptt_loss=tb_loss,
                        rnn_time_step_err=rts_err, profile=prof)


def bf16_steps(name: str, net, fit, poison) -> dict:
    """``BF16_STEPS`` loss-scaled steps under ``DL4J_TPU_BF16=1`` (the
    scale triple after each), then one step made non-finite by an inf
    planted in a weight: params, states and updater state bit-equal to
    before, the scale halved and one skip counted."""
    with env_set(DL4J_TPU_BF16="1"):
        fit()  # warm: cuDNN's bf16 picks
        triples, ms = [], []
        for _ in range(BF16_STEPS):
            ms.append(wall_ms(fit, 1))
            s = net.loss_scale
            triples.append((s["scale"], s["good"], s["skipped"]))
        before = net.loss_scale
        poison()
        keep = lowprec.tree_map(torch.clone, (net.params, net.states,
                                              net.updater_state))
        fit()
        after = net.loss_scale
        same = all(torch.equal(a, b) for a, b in zip(
            lowprec.tree_leaves((net.params, net.states, net.updater_state)),
            lowprec.tree_leaves(keep)))
    step_ms = float(np.mean(ms))
    print(f"{name} bf16: {step_ms:.3f} ms a step; (scale, good, skipped) "
          f"after each: {triples}; the forced non-finite step: {before} -> "
          f"{after}, params, states and updater state bit-equal: {same}")
    check(same and after["skipped"] == before["skipped"] + 1
          and after["scale"] == max(before["scale"] / 2, 1.0)
          and net.dispatch_stats.loss_scale_skips == after["skipped"],
          f"{name}'s forced non-finite bf16 step was not skipped")
    return dict(step_ms=step_ms, triples=triples, forced_before=before,
                forced_after=after)


def phase_bf16(seed: int, dev, resnet, resnet_batch, resnet_f32_ms) -> dict:
    print(f"== (d) bf16 loss-scaled training (DL4J_TPU_BF16=1): LeNet-5 at "
          f"batch {LENET_BATCH} and ResNet-50 at batch {RESNET_BATCH}, "
          f"{BF16_STEPS} steps each and one forced non-finite step ==")
    lenet = build_lenet5(device=dev)
    xl, yl, _ = load_mnist_info(train=True, num_examples=LENET_BATCH)
    xl, yl = torch.from_numpy(xl).to(dev), torch.from_numpy(yl).to(dev)
    fit_l = lambda: lenet.fit(xl, yl)
    fit_l()
    f32_ms = wall_ms(fit_l, BF16_STEPS)

    def poison_l():
        with torch.no_grad():
            lenet.params[0]["W"][0, 0, 0, 0] = float("inf")

    rep = {"lenet5": bf16_steps("LeNet-5", lenet, fit_l, poison_l)}
    rep["lenet5"]["f32_step_ms"] = f32_ms
    del lenet
    x, y = resnet_batch

    def poison_r():
        with torch.no_grad():
            resnet.params["stem_conv"]["W"][0, 0, 0, 0] = float("inf")

    rep["resnet50"] = bf16_steps("ResNet-50", resnet,
                                 lambda: resnet.fit(x, y), poison_r)
    rep["resnet50"]["f32_step_ms"] = resnet_f32_ms
    print(f"bf16 against f32 a step: LeNet-5 {rep['lenet5']['step_ms']:.3f} "
          f"vs {f32_ms:.3f} ms; ResNet-50 {rep['resnet50']['step_ms']:.3f} "
          f"vs {resnet_f32_ms:.3f} ms")
    return rep


def phase_graph(seed: int, dev):
    """(K1/K2 launches of the seq2seq path, the report of (a)-(d))."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resnet, net, batch = phase_resnet(seed, dev)
    rep = {"resnet50": resnet}
    rep["bf16"] = phase_bf16(seed, dev, net, batch, resnet["step_ms"])
    del net, batch
    rep["googlenet"] = phase_googlenet(seed, dev)
    counts, rep["seq2seq"] = phase_seq2seq(seed, dev)
    rep["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    rep["wall_s"] = time.perf_counter() - t0
    print(f"the ComputationGraph phase: {rep['wall_s']:.1f} s")
    return counts, rep


def percentile(values, q: float) -> float:
    values = sorted(values)
    return values[min(len(values) - 1, int(len(values) * q))]


def phase_embed(seed: int, dev, w2v_table):
    """/embed through the engine: the retrieval bench's MLP (p50/p99 of
    128 single-row calls, batcher against the direct call), ResNet-50 as
    a graph record, BERT-base under mean, cls and max pooling through K5,
    and the word2vec table as a lookup. (K5 launches, the report.)"""
    print(f"== /embed: the MLP {EMBED_MLP} (bench.py:3041-3048), ResNet-50 "
          f"(a graph record), BERT-base through K5 (mean, cls, max), the "
          f"word2vec table; every model but the table loaded through POST "
          f"/models from a zip ==")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rep: dict = {}
    eng = ServingEngine(device=dev).start()
    tmp = tempfile.mkdtemp(prefix="embed_")
    try:
        # the MLP
        mlp = MultiLayerNetwork(mlp_conf(EMBED_MLP, seed), device=dev).init()
        path = os.path.join(tmp, "mlp.zip")
        write_model(mlp, path)
        del mlp
        for action in ({"action": "load", "name": "mlp", "path": path,
                        "input_shape": [EMBED_MLP[0]]},
                       {"action": "serve", "name": "mlp"}):
            code, _, body = _call(eng.url, "/models", action)
            check(code == 200, f"POST /models {action['action']} mlp: {body}")
        rng = np.random.default_rng(seed + 60)
        xs = rng.normal(size=(EMBED_CALLS, EMBED_MLP[0])).astype(np.float32)
        for i in range(4):
            eng.embed(xs[i:i + 1])  # warm
        lat = []
        for i in range(EMBED_CALLS):
            t1 = time.perf_counter()
            eng.embed(xs[i:i + 1])
            lat.append((time.perf_counter() - t1) * 1e3)
        rec = eng.registry.get("mlp")
        errs = []
        for n in (1, 5, 8):
            via = eng.embed(xs[:n])
            direct = eng._direct_embed(rec, xs[:n], None, None)
            errs.append(float(np.abs(via - direct).max()))
        code, _, body = _call(eng.url, "/embed", {"batch": xs[:3].tolist()})
        code1, _, body1 = _call(eng.url, "/embed",
                                {"record": xs[0].tolist()})
        b, b1 = json.loads(body), json.loads(body1)
        rep["mlp"] = dict(p50_ms=percentile(lat, 0.5),
                          p99_ms=percentile(lat, 0.99), calls=EMBED_CALLS,
                          batcher_vs_direct_err=max(errs),
                          http=[code, code1], dim=b.get("dim"))
        print(f"MLP: {EMBED_CALLS} single-row embed calls p50 "
              f"{rep['mlp']['p50_ms']:.3f} ms, p99 {rep['mlp']['p99_ms']:.3f}"
              f" ms; batcher against the direct call at 1, 5, 8 rows: "
              f"{max(errs):.2e} (tol {TOL_EMBED}); HTTP {code} "
              f"{sorted(b)} dim {b.get('dim')}, {code1} {sorted(b1)}")
        check(max(errs) <= TOL_EMBED and code == code1 == 200
              and b["dim"] == EMBED_MLP[1] and "embeddings" in b
              and "embedding" in b1, "/embed of the MLP failed")
        # ResNet-50 as a graph record
        res = build_resnet50(input_size=RESNET_SIZE, device=dev)
        path = os.path.join(tmp, "resnet50.zip")
        write_model(res, path)
        del res
        code, _, body = _call(eng.url, "/models", {
            "action": "load", "name": "resnet", "path": path,
            "input_shape": [RESNET_SIZE, RESNET_SIZE, 3]})
        check(code == 200, f"POST /models load resnet: {body}")
        rec = eng.registry.get("resnet")
        imgs = rng.random((2, RESNET_SIZE, RESNET_SIZE, 3),
                          dtype=np.float32)
        got = eng.embed_for("resnet", None, imgs)
        want = rec.model.feed_forward(imgs)["avgpool"].reshape(
            2, -1).cpu().numpy()
        probs = eng.predict_for("resnet", None, imgs)
        r_err = float(np.abs(got - want).max())
        rep["resnet50"] = dict(dim=int(got.shape[1]), err_vs_direct=r_err,
                               predict_shape=list(probs.shape),
                               predict_row_sums=probs.sum(1).tolist())
        print(f"ResNet-50 record: embed dim {got.shape[1]} (vertex "
              f"{rec.embed_adapter().layer!r}), against feed_forward "
              f"{r_err:.2e}; /predict -> {list(probs.shape)}, row sums "
              + " ".join(f"{v:.6f}" for v in probs.sum(1)))
        check(got.shape == (2, 2048) and r_err <= TOL_EMBED
              and probs.shape == (2, 1000)
              and np.allclose(probs.sum(1), 1.0, atol=1e-5),
              "/embed or /predict of the ResNet-50 graph record failed")
        # BERT-base
        cfg = bert_mod.BertConfig(**BERT_KW)
        path = os.path.join(tmp, "bert.zip")
        bert_mod.BertMLM(cfg, device=dev).save(path)
        code, _, body = _call(eng.url, "/models", {"action": "load",
                                                   "name": "bert",
                                                   "path": path})
        check(code == 200, f"POST /models load bert: {body}")
        rec = eng.registry.get("bert")
        ids = bert_tokens(seed + 61)[:EMBED_BERT_N, :EMBED_BERT_T].copy()
        ids[0, EMBED_BERT_T // 2:] = 0  # a padded row
        with plain_flash():
            ref = rec.model.embed_tokens(ids)
        pooled = {"mean": ref.mean(axis=1), "cls": ref[:, 0],
                  "max": ref.max(axis=1)}
        flash_attention_block.launches = 0
        flash_attention_block_plain.launches = 0
        code, _, body = _call(eng.url, "/embed", {"tokens": ids.tolist(),
                                                  "model": "bert"})
        b = json.loads(body)
        errs = {"mean": float(np.abs(np.asarray(b["embeddings"])
                                     - pooled["mean"]).max())}
        for pool in ("cls", "max"):
            out = eng._direct_embed(rec, ids, None, pool)
            errs[pool] = float(np.abs(out - pooled[pool]).max())
        k5 = {"flash_attention_block": flash_attention_block.launches,
              "flash_attention_block_plain":
                  flash_attention_block_plain.launches}
        layers = cfg.n_layers
        rep["bert"] = dict(dim=b.get("dim"), err_vs_plain=errs,
                           launches=k5, rows=EMBED_BERT_N, t=EMBED_BERT_T)
        print(f"BERT-base record: /embed {code} dim {b.get('dim')}; mean, "
              f"cls and max against the plain attention: "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f" (tol {TOL_EXT_F32}); launches {k5}")
        check(code == 200 and b["dim"] == cfg.d_model
              and max(errs.values()) <= TOL_EXT_F32,
              "/embed of BERT disagrees with the plain attention")
        check(k5["flash_attention_block"] == 3 * layers
              and k5["flash_attention_block_plain"] == 0,
              "/embed of BERT did not run K5 once per layer per call")
        # the word2vec table as a lookup
        eng.registry.load("w2v", model=w2v_table)
        wid = rng.integers(0, w2v_table.syn0.shape[0], 8)
        code, _, body = _call(eng.url, "/embed", {
            "tokens": [[int(i)] for i in wid], "model": "w2v"})
        w = np.asarray(json.loads(body)["embeddings"], np.float32)
        w_ok = code == 200 and np.array_equal(w, w2v_table.syn0[wid])
        rep["word2vec"] = dict(dim=int(w.shape[1]), equal=bool(w_ok))
        print(f"word2vec table: /embed {code} dim {w.shape[1]}, rows equal "
              f"syn0's: {w_ok}")
        check(w_ok, "/embed of the word2vec table is not its rows")
        _, _, body = _call(eng.url, "/models")
        report = json.loads(body)["embed"]
        _, _, text = _call(eng.url, "/metrics",
                           headers={"Accept": "text/plain"})
        stats = eng.retrieval_stats.snapshot()
        rep.update(embed_report=report, retrieval_stats=stats)
        print(f"GET /models embed: {report}; retrieval_stats "
              f"{ {k: stats[k] for k in ('embed_requests', 'embed_rows')} }")
        check(report.get("mlp@v1") == {"kind": "feedforward",
                                       "dim": EMBED_MLP[1]}
              and report.get("resnet@v1") == {"kind": "feedforward",
                                              "dim": 2048}
              and report.get("bert@v1") == {"kind": "bert",
                                            "dim": cfg.d_model}
              and report.get("w2v@v1", {}).get("kind") == "lookup"
              and "embed_requests" in text,
              "embed_report or the retrieval ledger is wrong")
    finally:
        eng.stop(drain=False)
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    rep["wall_s"] = time.perf_counter() - t0
    print(f"the /embed phase: {rep['wall_s']:.1f} s")
    return k5, rep


def obs_journal_at(path: str):
    """Turn the obs gate on with the journal at ``path``
    (``DL4J_TPU_OBS_JOURNAL``): the process's journal is made anew there
    and the tracer writes its spans into it, from a clear ring."""
    os.environ["DL4J_TPU_OBS_JOURNAL"] = path
    obs_journal._DEFAULT = None
    jr = obs_journal.default_journal()
    obs_trace.tracer().attach(journal=jr)
    obs_trace.tracer().clear()
    obs_trace.set_enabled(True)
    return jr


def clustered_rows(rng, centers, n: int, noise: float = SEARCH_NOISE):
    """n rows around randomly picked centers (the JAX bench's regime,
    ``bench.py:2994-3003``)."""
    pick = rng.integers(0, centers.shape[0], n)
    return (centers[pick] + noise * rng.standard_normal(
        (n, centers.shape[1]), dtype=np.float32)).astype(np.float32)


def f64_oracle(host_vecs, ids, q, k: int):
    """Top-(k+1) ids and scores of cosine queries over the store's host
    master rows, in f64 on the host, in blocks of rows."""
    qn = q.astype(np.float64)
    qn /= np.maximum(np.linalg.norm(qn, axis=1, keepdims=True), 1e-12)
    scores = np.empty((q.shape[0], host_vecs.shape[0]), np.float64)
    for i in range(0, host_vecs.shape[0], 1 << 17):
        scores[:, i:i + (1 << 17)] = qn @ host_vecs[i:i + (1 << 17)].astype(
            np.float64).T
    top = np.argpartition(-scores, k, axis=1)[:, :k + 1]
    top = np.take_along_axis(top, np.argsort(
        -np.take_along_axis(scores, top, 1), axis=1, kind="stable"), 1)
    return ids[top], np.take_along_axis(scores, top, 1)


def margin_check(got_ids, got_scores, ref_ids, ref_scores, k: int,
                 margin: float):
    """(rows whose top-k set was comparable, rows whose set differed, max
    |score - reference|, positions compared, positions that differed):
    sets where the reference's k-th and (k+1)-th scores are ``margin``
    apart, positions where a rank's score is ``margin`` from both
    neighbours."""
    rows = bad_rows = pos = bad_pos = 0
    for r in range(ref_ids.shape[0]):
        s = ref_scores[r]
        if s[k - 1] - s[k] >= margin:
            rows += 1
            bad_rows += set(got_ids[r]) != set(ref_ids[r, :k])
        for i in range(k):
            lo = s[i - 1] - s[i] if i else np.inf
            if min(lo, s[i] - s[i + 1]) >= margin:
                pos += 1
                bad_pos += got_ids[r, i] != ref_ids[r, i]
    err = float(np.abs(got_scores - ref_scores[:, :k]).max())
    return rows, bad_rows, err, pos, bad_pos


def search_bounds(snap, b: int, nprobe: int):
    """Least device time of one exact and one IVF search of ``b`` queries:
    the exact scan reads every live row; the IVF probe reads the
    centroids and gathers nprobe x cap_per candidate rows (and their
    member ids) per query. f32 products at PEAK_F32_FLOPS."""
    d = snap.dim
    ex_bytes = snap.n * d * 4 + b * d * 4
    ex = bound(ex_bytes, 2.0 * b * snap.n * d, PEAK_F32_FLOPS)
    m = nprobe * snap.cap_per
    k_c = int(snap.centroids.shape[0])
    ivf_bytes = k_c * d * 4 + b * m * (d * 4 + 8) + b * d * 4
    ivf = bound(ivf_bytes, 2.0 * b * (k_c + m) * d, PEAK_F32_FLOPS)
    return (ex, ex_bytes), (ivf, ivf_bytes)


def search_qps(search, q, b: int, k: int, reps: int = SEARCH_REPS) -> float:
    """Median queries/s of ``search`` over ``q`` in batches of b (host
    wall: upload, device work, read-back, id mapping)."""
    search(q[:b], k=k)
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for i in range(0, q.shape[0], b):
            search(q[i:i + b], k=k)
        out.append(q.shape[0] / (time.perf_counter() - t0))
    return float(np.median(out))


def phase_search(seed: int, dev, card: str):
    """/search on the card: a 1,000,000 x 768 IVF store built and
    published at its default capacity, exact ids against an f64 oracle,
    IVF recall, queries/s, HTTP latency; the BERT leg through /embed
    (K5); a generation swap under HTTP load fed by a StreamSource; the
    drift veto."""
    print(f"== /search: VectorStore({SEARCH_DIM}, kind='ivf') at its "
          f"default capacity, {SEARCH_ROWS:,} rows of a clustered corpus "
          f"({SEARCH_CENTERS} centers, noise {SEARCH_NOISE}); BERT-base "
          f"passages through /embed; a swap under load; the drift veto "
          f"[{card}] ==")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    rep: dict = {"card": card}
    tmp = tempfile.mkdtemp(prefix="search_")
    rng = np.random.default_rng(seed + 70)
    eng = ServingEngine(device=dev).start()
    try:
        # -- the 1M store: build and publish ------------------------------
        mem0 = torch.cuda.memory_allocated()
        store = VectorStore(SEARCH_DIM, kind="ivf", name="ivf", device=dev)
        rows_auto = ann_arena_rows(SEARCH_DIM, device=dev)
        print(f"capacity {store.capacity:,} rows (ann_arena_rows on "
              f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.1f}"
              f" GiB: {rows_auto:,}, clamp [1024, {1 << 20:,}])")
        check(store.capacity == rows_auto == SEARCH_CAPACITY,
              f"the store sized itself to {store.capacity} rows")
        centers = rng.standard_normal((SEARCH_CENTERS, SEARCH_DIM),
                                      dtype=np.float32)
        # the corpus is made on the card, and each block upserted from
        # there (normalized on the card, one copy down to the master)
        gen = torch.Generator(device=dev).manual_seed(seed + 70)
        centers_d = torch.from_numpy(centers).to(dev)
        gen_s = up_s = 0.0
        for lo in range(0, SEARCH_ROWS, SEARCH_BATCH):
            t0 = time.perf_counter()
            n = min(SEARCH_BATCH, SEARCH_ROWS - lo)
            block = centers_d[torch.randint(
                0, SEARCH_CENTERS, (n,), generator=gen, device=dev)] \
                + SEARCH_NOISE * torch.randn(n, SEARCH_DIM, generator=gen,
                                             device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            store.upsert(np.arange(lo, lo + n), block)
            torch.cuda.synchronize()
            gen_s += t1 - t0
            up_s += time.perf_counter() - t1
        del block, centers_d
        t0 = time.perf_counter()
        snap = store.publish()
        torch.cuda.synchronize()
        pub_s = time.perf_counter() - t0
        lp = dict(store.last_publish)
        slots = torch.from_numpy(np.concatenate([
            np.arange(SEARCH_ROWS), np.full(snap.n_pad - SEARCH_ROWS,
                                            store.capacity)])).to(dev)
        pack_ms = device_ms(lambda: store._staging.index_select(0, slots),
                            iters=3, warmup=1)
        del slots
        eng.register_index("ivf", store)
        hbm = eng.hbm_report()["indexes"]["ivf"]
        rise = torch.cuda.memory_allocated() - mem0
        rep["build"] = dict(
            capacity=store.capacity, rows=snap.n, n_pad=snap.n_pad,
            corpus_gen_s=gen_s, upsert_s=up_s, publish_s=pub_s,
            pack_device_ms=pack_ms, **lp, report=store.report(),
            hbm_indexes_bytes=hbm, memory_allocated_rise=rise)
        print(f"build: corpus made on the card {gen_s:.2f} s, "
              f"{SEARCH_ROWS // SEARCH_BATCH + (SEARCH_ROWS % SEARCH_BATCH > 0)}"
              f" upserts of {SEARCH_BATCH:,} {up_s:.2f} s; publish "
              f"{pub_s:.2f} s = pack {lp['pack_s']:.3f} s (device "
              f"{pack_ms:.2f} ms) + k-means++ seeding {lp['seed_s']:.2f} s "
              f"+ {lp['iterations']} Lloyd steps {lp['lloyd_s']:.2f} s + "
              f"assignment {lp['assign_s']:.3f} s + member table "
              f"{lp['members_s']:.3f} s; {lp['clusters']} clusters, "
              f"cap_per {lp['cap_per']}")
        print(f"report {store.report()}")
        print(f"hbm_report indexes: {hbm / 2**30:.3f} GiB (the staging "
              f"arena); memory_allocated rose {rise / 2**30:.3f} GiB "
              f"(staging + the packed generation + centroids and members)")
        check(snap.n == SEARCH_ROWS and snap.centroids is not None
              and lp["clusters"] == int(np.sqrt(SEARCH_ROWS))
              and snap.n_pad == bucket_size(SEARCH_ROWS + 1),
              "the 1M publish did not build the IVF index it should")
        check(rise >= hbm, "the index holds less memory than its report")
        # -- exact against the f64 oracle ---------------------------------
        q16 = clustered_rows(rng, centers, SEARCH_ORACLE_Q)
        ids, scores = store.search_exact(q16, k=SEARCH_K)
        t0 = time.perf_counter()
        ref_ids, ref_scores = f64_oracle(store._host_vecs[:SEARCH_ROWS],
                                         store._ids[:SEARCH_ROWS], q16,
                                         SEARCH_K)
        oracle_s = time.perf_counter() - t0
        rows_c, bad_rows, err, pos, bad_pos = margin_check(
            ids, scores, ref_ids, ref_scores, SEARCH_K, SEARCH_MARGIN)
        rep["exact_vs_f64"] = dict(queries=SEARCH_ORACLE_Q, k=SEARCH_K,
                                   rows_compared=rows_c, rows_differ=bad_rows,
                                   positions_compared=pos,
                                   positions_differ=int(bad_pos),
                                   max_abs_score_err=err, oracle_s=oracle_s)
        print(f"exact vs the f64 host scan ({SEARCH_ORACLE_Q} queries, "
              f"k={SEARCH_K}): top-k sets compared on {rows_c} rows (margin "
              f">= {SEARCH_MARGIN}), {bad_rows} differ; {pos} ranks "
              f"compared, {bad_pos} differ; max |score err| {err:.2e} "
              f"(tol {SEARCH_SCORE_TOL})")
        check(bad_rows == 0 and bad_pos == 0 and err <= SEARCH_SCORE_TOL
              and pos > 0, "the exact index disagrees with the f64 oracle")
        # -- IVF recall against the exact index ---------------------------
        q256 = clustered_rows(rng, centers, SEARCH_RECALL_Q)
        recall = store.probe_recall(q256, k=SEARCH_K)
        rep["recall_at_10"] = recall
        print(f"IVF recall@{SEARCH_K} against ExactIndex on the same "
              f"snapshot over {SEARCH_RECALL_Q} queries: {recall:.4f} "
              f"(nprobe {store._ivf._n_probe(lp['clusters'])}, bar 0.95)")
        check(recall >= 0.95, f"IVF recall {recall} below 0.95")
        # -- throughput at B = 8 ------------------------------------------
        q1k = clustered_rows(rng, centers, SEARCH_QPS_Q)
        nprobe = store._ivf._n_probe(lp["clusters"])
        qd = torch.from_numpy(q1k[:SEARCH_B]).to(dev)
        ex_ms = device_ms(lambda: _exact_topk(qd, snap.vecs, snap.n,
                                              SEARCH_K, True), iters=20)
        ivf_ms = device_ms(lambda: _ivf_topk(
            qd, snap.vecs, snap.centroids, snap.members, SEARCH_K, nprobe,
            True), iters=20)
        (ex_b, ex_bytes), (ivf_b, ivf_bytes) = search_bounds(
            snap, SEARCH_B, nprobe)
        exact_qps = search_qps(store.search_exact, q1k, SEARCH_B, SEARCH_K)
        ivf_qps = search_qps(store.search, q1k, SEARCH_B, SEARCH_K)
        rep["throughput"] = dict(
            batch=SEARCH_B, k=SEARCH_K, queries=SEARCH_QPS_Q,
            reps=SEARCH_REPS, exact_qps=exact_qps, ivf_qps=ivf_qps,
            exact_device_ms=ex_ms, ivf_device_ms=ivf_ms,
            exact_bound_ms=ex_b[0], exact_bound_by=ex_b[1],
            exact_bytes=ex_bytes, ivf_bound_ms=ivf_b[0],
            ivf_bound_by=ivf_b[1], ivf_bytes=ivf_bytes, nprobe=nprobe,
            cap_per=snap.cap_per)
        print(f"B={SEARCH_B}, k={SEARCH_K}, median of {SEARCH_REPS} x "
              f"{SEARCH_QPS_Q} queries: exact {exact_qps:.1f} q/s "
              f"(device {ex_ms:.3f} ms a batch, bound {ex_b[0]:.3f} ms by "
              f"{ex_b[1]}: {ex_bytes / 1e9:.3f} GB at 3.35 TB/s), IVF "
              f"{ivf_qps:.1f} q/s (device {ivf_ms:.3f} ms a batch, bound "
              f"{ivf_b[0]:.4f} ms by {ivf_b[1]}: {ivf_bytes / 1e6:.1f} MB "
              f"of centroids and nprobe {nprobe} x cap_per {snap.cap_per} "
              f"gathered rows a query)")
        check(exact_qps > 0 and ivf_qps > 0, "no search throughput")
        # -- POST /search latency -----------------------------------------
        lat = []
        for i in range(SEARCH_HTTP_CALLS):
            t0 = time.perf_counter()
            code, _, body = _call(eng.url, "/search", {
                "index": "ivf", "query": q256[i % SEARCH_RECALL_Q].tolist(),
                "k": SEARCH_K})
            lat.append((time.perf_counter() - t0) * 1e3)
            check(code == 200, f"POST /search: {code} {body[:200]}")
        b = json.loads(body)
        rep["http"] = dict(calls=SEARCH_HTTP_CALLS,
                           p50_ms=percentile(lat, 0.5),
                           p99_ms=percentile(lat, 0.99))
        print(f"POST /search: {SEARCH_HTTP_CALLS} single-query calls p50 "
              f"{rep['http']['p50_ms']:.3f} ms, p99 "
              f"{rep['http']['p99_ms']:.3f} ms; keys {sorted(b)}")
        check(sorted(b) == ["ids", "scores"]
              and len(b["ids"][0]) == SEARCH_K, "a malformed /search answer")
        del snap, qd
        eng.unregister_index("ivf")
        del store
        torch.cuda.empty_cache()
        rep["bert"], k5 = search_bert_leg(eng, seed, dev, tmp)
        rep["swap"], rep["drift"] = search_swap_leg(eng, seed, dev, tmp)
        _, _, body = _call(eng.url, "/models")
        rep["indexes"] = json.loads(body)["indexes"]
        print(f"GET /models indexes: "
              + "; ".join(f"{k}: rows {v['rows']}, generation "
                          f"{v['generation']}, {v['kind']}"
                          for k, v in rep["indexes"].items()))
    finally:
        obs_trace.set_enabled(None)
        eng.stop(drain=False)
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    rep["wall_s"] = time.perf_counter() - t_phase
    print(f"the /search phase: {rep['wall_s']:.1f} s")
    return k5, rep


def search_bert_leg(eng, seed: int, dev, tmp: str):
    """2,048 passages through /embed of BERT-base (a zip loaded through
    POST /models, mean pooling, K5 once per layer per call) into the store
    ``bert``; 64 passages embedded again and searched over HTTP; every
    passage's own embedding at rank 1."""
    cfg = bert_mod.BertConfig(**BERT_KW)
    path = os.path.join(tmp, "bert.zip")
    bert_mod.BertMLM(cfg, device=dev).save(path)
    code, _, body = _call(eng.url, "/models", {"action": "load",
                                               "name": "bert",
                                               "path": path})
    check(code == 200, f"POST /models load bert: {body}")
    ids = 1 + markov_tokens(seed + 71, (SEARCH_PASSAGES, SEARCH_PASSAGE_T),
                            BERT_KW["vocab_size"] - 1)
    flash_attention_block.launches = 0
    flash_attention_block_plain.launches = 0
    calls = 0
    embs = []
    t0 = time.perf_counter()
    for lo in range(0, SEARCH_PASSAGES, SEARCH_EMBED_ROWS):
        code, _, body = _call(eng.url, "/embed", {
            "tokens": ids[lo:lo + SEARCH_EMBED_ROWS].tolist(),
            "model": "bert", "pool": "mean"})
        check(code == 200, f"/embed of passages: {code} {body[:200]}")
        embs.append(np.asarray(json.loads(body)["embeddings"], np.float32))
        calls += 1
    embed_s = time.perf_counter() - t0
    embs = np.concatenate(embs)
    store = VectorStore(cfg.d_model, capacity=SEARCH_PASSAGES, kind="exact",
                        name="bert", device=dev)
    store.upsert(np.arange(SEARCH_PASSAGES), embs)
    store.publish()
    eng.register_index("bert", store)
    own = np.concatenate([store.search(embs[i:i + 256], k=1)[0][:, 0]
                          for i in range(0, SEARCH_PASSAGES, 256)])
    pick = np.random.default_rng(seed + 72).choice(
        SEARCH_PASSAGES, SEARCH_BERT_Q, replace=False)
    code, _, body = _call(eng.url, "/embed", {
        "tokens": ids[pick].tolist(), "model": "bert", "pool": "mean"})
    check(code == 200, f"/embed of queries: {code} {body[:200]}")
    calls += 1
    qe = json.loads(body)["embeddings"]
    code, _, body = _call(eng.url, "/search", {"index": "bert",
                                               "queries": qe,
                                               "k": SEARCH_K})
    check(code == 200, f"/search bert: {code} {body[:200]}")
    top1 = np.asarray(json.loads(body)["ids"])[:, 0]
    k5 = {"flash_attention_block": flash_attention_block.launches,
          "flash_attention_block_plain":
              flash_attention_block_plain.launches}
    rep = dict(passages=SEARCH_PASSAGES, tokens=SEARCH_PASSAGE_T,
               embed_calls=calls, embed_s=embed_s,
               own_rank1=int((own == np.arange(SEARCH_PASSAGES)).sum()),
               http_rank1=int((top1 == pick).sum()), queries=SEARCH_BERT_Q,
               launches=k5)
    print(f"BERT leg: {SEARCH_PASSAGES} passages of {SEARCH_PASSAGE_T} "
          f"tokens through /embed in {calls - 1} calls of "
          f"{SEARCH_EMBED_ROWS} ({embed_s:.2f} s); own embedding at rank 1: "
          f"{rep['own_rank1']}/{SEARCH_PASSAGES}; {SEARCH_BERT_Q} passages "
          f"embedded again and searched over HTTP at rank 1: "
          f"{rep['http_rank1']}/{SEARCH_BERT_Q}; launches {k5} over "
          f"{calls} /embed calls")
    check(rep["own_rank1"] == SEARCH_PASSAGES
          and rep["http_rank1"] == SEARCH_BERT_Q,
          "a passage's embedding did not come back at rank 1")
    check(k5["flash_attention_block"] == cfg.n_layers * calls
          and k5["flash_attention_block_plain"] == 0,
          "/embed of BERT did not run K5 once per layer per call")
    return rep, k5


def search_swap_leg(eng, seed: int, dev, tmp: str):
    """The bench's 65,536 x 768 store searched from four HTTP clients while
    a StreamSource feed runs five windows (4,096 upserts, 1,024 deletes,
    a publish each); then a window shifted by 5 sigma, vetoed by the
    DriftMonitor on the corpus's moments."""
    rng = np.random.default_rng(seed + 73)
    centers = rng.standard_normal((int(np.sqrt(SWAP_ROWS)), SEARCH_DIM),
                                  dtype=np.float32)
    corpus = clustered_rows(rng, centers, SWAP_ROWS)
    # room for every window's upserts and the shifted window's 1,024
    store = VectorStore(SEARCH_DIM, capacity=SWAP_ROWS + SWAP_WINDOWS
                        * SWAP_UPSERTS + 1024, kind="ivf", name="swap",
                        device=dev)
    store.upsert(np.arange(SWAP_ROWS), corpus)
    store.publish()
    eng.register_index("swap", store)
    live = {1: set(store.snapshot.ids[:store.snapshot.n].tolist())}
    q = clustered_rows(rng, centers, 64)
    stop = threading.Event()
    answers, failures = [], []

    def client(c):
        i = c
        while not stop.is_set():
            code, _, body = _call(eng.url, "/search", {
                "index": "swap", "queries": q[i % 8 * 8:(i % 8 + 1) * 8]
                .tolist(), "k": SEARCH_K})
            if code != 200:
                failures.append((code, body[:200]))
            else:
                answers.append(json.loads(body)["ids"])
            i += 4

    src = StreamSource(idle_s=0.05)
    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    reports = []
    t0 = time.perf_counter()
    try:
        for w in range(SWAP_WINDOWS):
            base = SWAP_ROWS + w * SWAP_UPSERTS
            fresh = clustered_rows(rng, centers, SWAP_UPSERTS)
            for lo in range(0, SWAP_UPSERTS, 1024):
                src.push(DataSet(fresh[lo:lo + 1024],
                                 np.arange(base + lo, base + lo + 1024)))
            src.push(("delete", np.arange(w * SWAP_DELETES,
                                          (w + 1) * SWAP_DELETES)))
            reports.append(store.feed_once(src))
            snap = store.snapshot
            live[snap.generation] = set(snap.ids[:snap.n].tolist())
    finally:
        stop.set()
        for t in threads:
            t.join()
    feed_s = time.perf_counter() - t0
    stray = sum(1 for a in answers
                if not any(set(x for row in a for x in row if x >= 0) <= s
                           for s in live.values()))
    gens = [1] + [r["generation"] for r in reports]
    swap = dict(rows=SWAP_ROWS, windows=SWAP_WINDOWS,
                upserts=SWAP_UPSERTS, deletes=SWAP_DELETES, feed_s=feed_s,
                answers=len(answers), failed=len(failures),
                answers_outside_a_generation=stray, generations=gens,
                reports=reports)
    print(f"swap under load: {len(answers)} HTTP searches from 4 clients "
          f"across {SWAP_WINDOWS} feed windows ({SWAP_UPSERTS} upserts, "
          f"{SWAP_DELETES} deletes, a publish each; {feed_s:.2f} s): "
          f"{len(failures)} failed, {stray} answers outside one "
          f"generation's live set; generations {gens}")
    check(not failures and stray == 0 and answers
          and gens == list(range(1, SWAP_WINDOWS + 2))
          and all(r["upserted"] == SWAP_UPSERTS
                  and r["deleted"] == SWAP_DELETES for r in reports),
          f"the swap under load failed: {failures[:3]}")
    # -- the drift veto ----------------------------------------------------
    jr = obs_journal_at(os.path.join(tmp, "search_journal.jsonl"))
    mean, std = corpus.mean(0), corpus.std(0)
    drift = DriftMonitor((mean, std))
    gen = store.generation
    shifted = corpus[:1024] + 5.0 * std
    src.push(DataSet(shifted, np.arange(900_000, 900_000 + 1024)))
    report = store.feed_once(src, drift=drift)
    try:
        store.publish(drift=drift)
        raised = False
    except PublishVetoed:
        raised = True
    src.close()
    obs_trace.set_enabled(None)
    jr.flush(fsync=True)
    vetoes = [e for e in FlightRecorder.load(jr.path)
              if e["kind"] == "retrieval.publish_veto"]
    stats = store.retrieval_stats.snapshot()
    veto = dict(report=report, raised=raised, generation=store.generation,
                max_z=drift.last_z, publish_vetoes=stats["publish_vetoes"],
                journal_vetoes=len(vetoes))
    print(f"drift veto: a window shifted by 5 sigma: feed_once vetoed "
          f"{report['vetoed']} (max z {drift.last_z:.2f}), publish(drift=) "
          f"raised PublishVetoed {raised}, generation {gen} -> "
          f"{store.generation}, publish_vetoes {stats['publish_vetoes']}, "
          f"{len(vetoes)} retrieval.publish_veto events in the journal")
    check(report["vetoed"] and not report["published"] and raised
          and store.generation == gen and stats["publish_vetoes"] == 2
          and len(vetoes) == 2, "the drift veto did not hold")
    return swap, veto


def obs_predict_burst(url: str, reqs, clients: int = N_CLIENTS) -> float:
    """The /predict requests over HTTP from ``clients`` threads; wall s."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as ex:
        answers = list(ex.map(lambda x: _post(
            url, {"batch": x.tolist()}, path="/predict"), reqs))
    wall = time.perf_counter() - t0
    check(all(s == 200 for s, _ in answers), "a /predict failed")
    return wall


def obs_launches(fn) -> dict:
    """Each kernel's launches during ``fn()`` (K1 and K4, K6, and their
    plain versions)."""
    fns = (lstm_scan, lstm_scan_plain) + KERNELS
    for f in fns:
        f.launches = 0
    fn()
    return {f.__name__: f.launches for f in fns}


def phase_obs(lm: TransformerLM, net: MultiLayerNetwork, burst_run,
              seed: int, dev):
    """The serving path traced and journaled (DL4J_TPU_OBS=1): a 64-request
    /predict burst on the char-RNN (K1), the 16-request /generate burst
    (K4, K6) and 64 searches; request spans, batch spans, decode-tick
    spans; the drain in the journal; an exporter scrape; /predict rows/s
    with obs on and off; launch counts equal with obs on and off."""
    print("== obs: DL4J_TPU_OBS=1 over /predict (char-RNN, K1), /generate "
          "(K4, K6) and /search; the journal in a temporary directory ==")
    tmp = tempfile.mkdtemp(prefix="obs_")
    reqs_gen, answers_gen = burst_run
    rng = np.random.default_rng(seed + 80)
    eye = np.eye(VOCAB, dtype=np.float32)
    reqs = [eye[rng.integers(0, VOCAB, (int(rng.integers(1, MAX_ROWS + 1)),
                                        SEQ))] for _ in range(N_PREDICT)]
    rep: dict = {}
    jr = obs_journal_at(os.path.join(tmp, "journal.jsonl"))
    tracer = obs_trace.tracer()
    peng = ServingEngine(model=net, device=dev).start()
    geng = ServingEngine(lm, device=dev).start()
    try:
        peng.registry.warmup(max_batch=peng.max_batch,
                             sample_row=np.zeros((SEQ, VOCAB), np.float32))
        obs_predict_burst(peng.url, reqs[:8])
        tracer.clear()
        # -- /predict: one request span each, its rid in one batch span ---
        obs_predict_burst(peng.url, reqs)
        rq = [s for s in tracer.spans("serve.request")]
        batches = tracer.spans("serve.batch")
        owner = {}
        for b in batches:
            for rid in b["attrs"]["request_ids"]:
                owner[rid] = owner.get(rid, 0) + 1
        rids = [s["attrs"]["rid"] for s in rq]
        pred = dict(requests=len(rq), batches=len(batches),
                    rids_in_one_batch=sum(owner.get(r) == 1 for r in rids))
        print(f"/predict burst: {len(rq)} serve.request spans, "
              f"{len(batches)} serve.batch spans, "
              f"{pred['rids_in_one_batch']} request ids each in exactly "
              f"one batch span's request_ids")
        check(len(rq) == N_PREDICT and pred["rids_in_one_batch"] == N_PREDICT
              and sum(b["attrs"]["rows"] for b in batches)
              == sum(x.shape[0] for x in reqs),
              "the /predict spans do not thread the request ids")
        # -- /generate: request spans and a batch span per decode tick ----
        d = geng.decoder
        ticks0 = d.decode_ticks
        tracer.clear()
        toks, wall = burst(geng, reqs_gen)
        equal = sum(a == b for a, b in zip(toks, answers_gen))
        ticks = d.decode_ticks - ticks0
        gspans = tracer.spans("serve.request")
        tick_spans = [s for s in tracer.spans("serve.batch")
                      if s["attrs"].get("kind") == "decode.paged"]
        gen = dict(requests=len(gspans), ticks=ticks,
                   tick_spans=len(tick_spans), wall_s=wall,
                   equal_to_burst=equal)
        print(f"/generate burst with obs on: {len(gspans)} serve.request "
              f"spans (kind generate), {len(tick_spans)} decode.paged "
              f"serve.batch spans for {ticks} ticks (lanes, tick_k on "
              f"each); {gen['equal_to_burst']}/{len(toks)} transcripts "
              f"equal to the burst without obs; {wall:.3f} s")
        check(len(gspans) == len(reqs_gen)
              and all(s["attrs"]["kind"] == "generate" for s in gspans)
              and len(tick_spans) == ticks
              and all("lanes" in s["attrs"] and "tick_k" in s["attrs"]
                      for s in tick_spans)
              and equal == len(reqs_gen),
              "the /generate spans are wrong, or obs changed an answer")
        # -- /search: 64 request spans -------------------------------------
        store = VectorStore(SEARCH_DIM, capacity=4096, kind="exact",
                            name="obs", device=dev)
        vecs = rng.standard_normal((4096, SEARCH_DIM), dtype=np.float32)
        store.upsert(np.arange(4096), vecs)
        store.publish()
        peng.register_index("default", store)
        tracer.clear()
        for i in range(64):
            code, _, body = _call(peng.url, "/search",
                                  {"query": vecs[i].tolist(), "k": 5})
            check(code == 200 and json.loads(body)["ids"][0][0] == i,
                  f"/search under obs: {code} {body[:200]}")
        sspans = tracer.spans("serve.request")
        print(f"/search: {len(sspans)} serve.request spans (kind search)")
        check(len(sspans) == 64 and all(s["attrs"]["kind"] == "search"
                                        for s in sspans),
              "the /search spans are wrong")
        # -- the exporter --------------------------------------------------
        exp = MetricsExporter().start()
        try:
            _, _, text = _call(exp.url, "/metrics")
        finally:
            exp.stop()
        ret = [ln for ln in text.splitlines()
               if ln.startswith("dl4j_retrieval_search_requests")]
        print(f"MetricsExporter scrape: {len(text.splitlines())} lines, "
              f"retrieval_stats samples {ret[:2]}")
        check(ret and any("dl4j_span_seconds" in ln
                          for ln in text.splitlines()),
              "the exporter scrape lacks retrieval_stats or span times")
        # -- rows/s with obs on and off, interleaved -----------------------
        rows = sum(x.shape[0] for x in reqs)
        pairs = []
        for _ in range(3):
            obs_trace.set_enabled(False)
            off = rows / obs_predict_burst(peng.url, reqs)
            obs_trace.set_enabled(True)
            on = rows / obs_predict_burst(peng.url, reqs)
            pairs.append((off, on))
        print("/predict rows/s (obs off, on), three interleaved pairs: "
              + ", ".join(f"({a:.1f}, {b:.1f})" for a, b in pairs))
        # -- launches with obs on and off: one client, one batch each ------
        greedy = [r for r in reqs_gen if r["temperature"] == 0.0][:2]

        def sequential():
            for x in reqs[:16]:
                _post(peng.url, {"batch": x.tolist()}, path="/predict")
            for r in greedy:
                _post(geng.url, r)

        obs_trace.set_enabled(False)
        c_off = obs_launches(sequential)
        obs_trace.set_enabled(True)
        c_on = obs_launches(sequential)
        print(f"launches, obs off: {c_off}; obs on: {c_on}")
        check(c_on == c_off and c_on["lstm_scan"] > 0
              and c_on["paged_attention"] > 0
              and c_on["flash_attention"] > 0
              and c_on["lstm_scan_plain"] == 0
              and c_on["paged_attention_plain"] == 0,
              "launch counts differ with obs on and off")
        # -- the drain in the journal --------------------------------------
        ok = peng.drain(30.0)
        events = FlightRecorder.load(jr.path)
        kinds = [e["kind"] for e in events]
        print(f"drain -> {ok}; the journal on disk ({jr.path}, fsync'd): "
              f"{len(events)} events, serve.drain at "
              f"{kinds.index('serve.drain') if 'serve.drain' in kinds else None},"
              f" serve.drain_complete at "
              f"{kinds.index('serve.drain_complete') if 'serve.drain_complete' in kinds else None}")
        check(ok and "serve.drain" in kinds and "serve.drain_complete" in kinds
              and kinds.index("serve.drain")
              < kinds.index("serve.drain_complete"),
              "the drain is not in the journal")
        rep = dict(predict=pred, generate=gen, search_spans=len(sspans),
                   exporter_retrieval_samples=len(ret),
                   predict_rows_per_s_off_on=pairs, launches_off=c_off,
                   launches_on=c_on, journal_events=len(events),
                   journal_kinds=sorted(set(kinds)))
    finally:
        obs_trace.set_enabled(None)
        peng.stop(drain=False)
        geng.stop(drain=False)
        shutil.rmtree(tmp, ignore_errors=True)
    return rep


# ---------------------------------------------------------------------------
# the training runtime (phase_runtime): record readers, the input pipeline
# and its stager, the native host feed, ResilientTrainer, early stopping
# ---------------------------------------------------------------------------

RT_STEPS, RT_EVERY, RT_KEEP = 24, 4, 2   # (a): steps, cadence, retention
RT_KILL, RT_TRANSIENT = 10, 3            # (a): SIGTERM after, error before
RT_WORKERS, RT_PREFETCH = 2, 4
ES_TRAIN, ES_HELD, ES_EPOCHS = 8192, 1024, 3     # (b)
TOL_ES_SCORE = 1e-6
IP_F, IP_C, IP_BATCH, IP_BATCHES = 96, 10, 256, 20  # (c) bench.py:2410
CK_STEPS, CK_BATCH = 30, 256                        # (c) bench.py:2251
RT_COUNTERS = (lstm_scan, lstm_scan_plain, lstm_scan_bwd, lstm_scan_bwd_plain)


class _FirstStep(pres.ChaosMonkey):
    """A monkey that injects nothing and notes the wall clock when the
    first step of the run completes."""

    def __init__(self, config=None):
        super().__init__(config or pres.ChaosConfig())
        self.first_step_at = None

    def after_step(self, step: int) -> None:
        if self.first_step_at is None:
            self.first_step_at = time.time()
        super().after_step(step)


def runtime_data(seed: int):
    """The char-RNN's 24 batches of 32 x 100 one-hot characters of the
    seeded Markov text (``CharRnn.batches``' layout: each row a contiguous
    stream), stacked in batch order ([768, 100, 80])."""
    text = markov_text(seed, TRAIN_BATCH * SEQ * RT_STEPS + 1,
                       [chr(32 + i) for i in range(VOCAB)])
    ids = np.frombuffer(text.encode("ascii"), np.uint8).astype(np.int64) - 32
    n = TRAIN_BATCH * SEQ * RT_STEPS
    eye = np.eye(VOCAB, dtype=np.float32)
    cut = lambda a: a.reshape(TRAIN_BATCH, RT_STEPS, SEQ).transpose(  # noqa: E731
        1, 0, 2).reshape(-1, SEQ)
    return eye[cut(ids[:n])], eye[cut(ids[1:n + 1])]


def runtime_net(seed: int, dev) -> MultiLayerNetwork:
    conf = char_rnn_conf(VOCAB, lstm_size=LSTM_H, num_layers=2, seed=seed,
                         tbptt_length=TBPTT, learning_rate=TRAIN_LR)
    return MultiLayerNetwork(conf, device=dev).init(input_shape=(1, VOCAB))


def runtime_child(mode: str, seed: int, ckpt_dir: str, out: str,
                  dev=None) -> int:
    """One run of (a) in its own process: ``uninterrupted``, ``preempted``
    (SIGTERM after step 10, a transient error before step 3 retried once,
    the step-10 checkpoint bit-flipped) or ``resumed``. Writes its
    losses, final params (torch.save), launch counts and times to
    ``out``; exits 3 when preempted."""
    dev = torch.device("cuda", 0) if dev is None else dev
    x, y = runtime_data(seed)
    rep = {"mode": mode}
    if mode == "uninterrupted":
        # first calls (cuBLAS, K1/K2 loads) outside the timed run
        warm = runtime_net(seed, dev)
        warm.fit(x[:TRAIN_BATCH], y[:TRAIN_BATCH])
        torch.cuda.synchronize()
        del warm
    net = runtime_net(seed, dev)
    mgr = pres.CheckpointManager(ckpt_dir, every_steps=RT_EVERY,
                                 keep_last=RT_KEEP, async_save=True)
    if mode == "preempted":
        monkey = pres.ChaosMonkey(pres.ChaosConfig(
            kill_at_step=RT_KILL, kill_mode="sigterm",
            transient_error_at_step=RT_TRANSIENT,
            corrupt_checkpoint={"at_step": RT_KILL, "mode": "bitflip"}))
        mgr.chaos = monkey
    else:
        monkey = _FirstStep()
    trainer = pres.ResilientTrainer(net, mgr, chaos=monkey,
                                    max_step_retries=1, device=dev)
    pipe = InputPipeline(ListDataSetIterator(x, y, TRAIN_BATCH),
                         workers=RT_WORKERS, prefetch=RT_PREFETCH,
                         device=dev, shard=None)
    for fn in RT_COUNTERS:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    code = 0
    try:
        trainer.fit(pipe, num_epochs=1)
    except pres.Preempted as e:
        rep["preempted_at"] = e.step
        code = 3
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rep["launches"] = {fn.__name__: fn.launches for fn in RT_COUNTERS}
    rep.update(losses=trainer.losses, step=trainer.step,
               resumed_step=trainer.resumed_step, wall_s=wall,
               resilience=dict(trainer.resilience_stats),
               pipeline=pipe.pipeline_stats.snapshot(),
               ckpt=dict(mgr.stats), chaos_log=monkey.log,
               first_step_at=getattr(monkey, "first_step_at", None),
               steps_run=len(trainer.losses),
               threads=sorted(t.name for t in threading.enumerate()))
    if mode == "uninterrupted":
        rep["ms_per_step"] = wall / RT_STEPS * 1e3
        rep.update(runtime_direct(seed, dev, x, y))
        rep.update(runtime_breakdown(seed, dev, x, y))
        rep.update(runtime_snapshots(net, dev))
    mgr.close()
    torch.save([t.detach().cpu() for t in lowprec.tree_leaves(net.params)],
               out + ".params.pt")
    with open(out, "w") as f:
        json.dump(rep, f, default=str)
    return code


def runtime_direct(seed: int, dev, x, y) -> dict:
    """The same 24 fits on tensors already on the card, from the same
    initialization: with one sync at the end, and with ``float(loss)``
    after every fit as the trainer reads it."""
    xs = [torch.from_numpy(x[i:i + TRAIN_BATCH]).to(dev)
          for i in range(0, len(x), TRAIN_BATCH)]
    ys = [torch.from_numpy(y[i:i + TRAIN_BATCH]).to(dev)
          for i in range(0, len(y), TRAIN_BATCH)]
    out = {}
    for key, sync in (("direct_ms_per_step", False),
                      ("direct_float_ms_per_step", True)):
        net = runtime_net(seed, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a, b in zip(xs, ys):
            loss = net.fit(a, b)
            if sync:
                float(loss)
        torch.cuda.synchronize()
        out[key] = (time.perf_counter() - t0) / len(xs) * 1e3
    return out


def runtime_breakdown(seed: int, dev, x, y) -> dict:
    """ms a step of the same 24 steps under ``ResilientTrainer`` with the
    pipeline, the checkpoints or both taken away (a plain
    ``ListDataSetIterator`` of host arrays; no manager)."""
    out = {}
    for key, piped, managed in (("trainer_plain_ms_per_step", False, False),
                                ("trainer_pipeline_ms_per_step", True, False),
                                ("trainer_ckpt_ms_per_step", False, True)):
        with tempfile.TemporaryDirectory() as tmp:
            mgr = (pres.CheckpointManager(tmp, every_steps=RT_EVERY,
                                          keep_last=RT_KEEP)
                   if managed else None)
            it = ListDataSetIterator(x, y, TRAIN_BATCH)
            if piped:
                it = InputPipeline(it, workers=RT_WORKERS,
                                   prefetch=RT_PREFETCH, device=dev,
                                   shard=None)
            trainer = pres.ResilientTrainer(runtime_net(seed, dev), mgr,
                                            device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.fit(it, num_epochs=1)
            torch.cuda.synchronize()
            out[key] = (time.perf_counter() - t0) / RT_STEPS * 1e3
            if mgr is not None:
                mgr.close()
    return out


def runtime_snapshots(net, dev) -> dict:
    """One async save's stall (the host snapshot) and one sync save's
    (snapshot, zip, fsync, commit), and the checkpoint's size."""
    with tempfile.TemporaryDirectory() as tmp:
        out = {}
        for key, async_save in (("async_save_stall_ms", True),
                                ("sync_save_stall_ms", False)):
            mgr = pres.CheckpointManager(os.path.join(tmp, key),
                                         async_save=async_save)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(net, step=1)
            out[key] = (time.perf_counter() - t0) * 1e3
            out[key.replace("stall", "snapshot")] = \
                mgr.stats["last_snapshot_s"] * 1e3
            mgr.flush()
            mgr.close()
            out["ckpt_mb"] = mgr.stats["bytes"] / 1e6
        return out


def run_runtime_child(mode: str, seed: int, ckpt_dir: str, tmp: str):
    out = os.path.join(tmp, f"{mode}.json")
    t_spawn = time.time()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--runtime-child", mode, "--runtime-dir", ckpt_dir, "--out", out],
        capture_output=True, text=True, timeout=600)
    want = 3 if mode == "preempted" else 0
    if proc.returncode != want:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
    check(proc.returncode == want,
          f"the {mode} child exited {proc.returncode}, not {want}")
    with open(out) as f:
        rep = json.load(f)
    rep["params"] = torch.load(out + ".params.pt")
    rep["spawned_at"] = t_spawn
    return rep


def phase_runtime_resilient(seed: int, tmp: str) -> dict:
    print(f"== (a) the char-RNN under ResilientTrainer, fed by "
          f"InputPipeline({RT_WORKERS} workers, prefetch {RT_PREFETCH}), "
          f"async checkpoints every {RT_EVERY} steps, three child "
          f"processes ==")
    ckpt = os.path.join(tmp, "runtime_ckpt")
    base = run_runtime_child("uninterrupted", seed,
                             os.path.join(tmp, "runtime_base"), tmp)
    kill = run_runtime_child("preempted", seed, ckpt, tmp)
    mgr = pres.CheckpointManager(ckpt)
    on_disk = [s for s, _ in mgr.checkpoints()]
    intact = mgr.latest_intact()
    res = run_runtime_child("resumed", seed, ckpt, tmp)
    k = res["resumed_step"]
    same_params = (len(base["params"]) == len(res["params"]) and all(
        torch.equal(a, b) for a, b in zip(base["params"], res["params"])))
    same_tail = res["losses"] == base["losses"][k:]
    same_head = kill["losses"] == base["losses"][:len(kill["losses"])]
    reexec_s = res["first_step_at"] - res["spawned_at"]
    pipe = base["pipeline"]
    print(f"uninterrupted: {base['step']} steps, {base['ms_per_step']:.2f} "
          f"ms a step through the trainer and the pipeline; the same "
          f"{RT_STEPS} fits on tensors on the card "
          f"{base['direct_ms_per_step']:.2f} ms a step "
          f"({base['direct_float_ms_per_step']:.2f} ms with float(loss) "
          f"after each); the trainer with neither the pipeline nor the "
          f"checkpoints {base['trainer_plain_ms_per_step']:.2f}, with the "
          f"pipeline only {base['trainer_pipeline_ms_per_step']:.2f}, with "
          f"the checkpoints only {base['trainer_ckpt_ms_per_step']:.2f}; "
          f"stall_fraction {pipe['stall_fraction']}, "
          f"consumer stall {pipe['stall_seconds']:.4f} s, producer stall "
          f"{pipe['producer_stall_seconds']:.4f} s; {base['ckpt']['saves']} "
          f"checkpoints ({base['ckpt']['skipped_busy']} skipped busy), "
          f"async snapshot {base['ckpt']['snapshot_s'] / max(1, base['ckpt']['saves']) * 1e3:.2f} ms "
          f"each in the run")
    print(f"one save after the run: async stall "
          f"{base['async_save_stall_ms']:.2f} ms (snapshot "
          f"{base['async_save_snapshot_ms']:.2f} ms), sync stall "
          f"{base['sync_save_stall_ms']:.2f} ms; a checkpoint is "
          f"{base['ckpt_mb']:.3f} MB")
    print(f"preempted: {kill['steps_run']} steps, Preempted at step "
          f"{kill.get('preempted_at')}, retries "
          f"{kill['resilience']['retries']}, chaos {kill['chaos_log']}; "
          f"on disk {on_disk}, latest intact "
          f"{None if intact is None else intact[1]['step']}")
    print(f"resumed from step {k}: {res['steps_run']} steps, the first "
          f"{reexec_s:.2f} s after the re-exec; params torch.equal to the "
          f"uninterrupted run: {same_params}; losses after step {k} equal: "
          f"{same_tail}")
    launches = {m: r["launches"] for m, r in
                (("uninterrupted", base), ("preempted", kill),
                 ("resumed", res))}
    print(f"K1/K2 launches: {launches}")
    check(kill.get("preempted_at") == RT_KILL,
          "the preempted child did not stop at the SIGTERM step")
    check(kill["resilience"]["retries"] == 1
          and kill["resilience"]["preemptions"] == 1,
          "the transient error was not retried exactly once")
    check((RT_KILL, "corrupt:bitflip") in [tuple(e) for e in
                                           kill["chaos_log"]],
          "the step-10 checkpoint was not corrupted")
    check(on_disk == [8, 10] and intact is not None
          and intact[1]["step"] == 8,
          f"latest_intact did not skip the corrupt step-10 checkpoint "
          f"({on_disk})")
    check(k == 8 and res["step"] == RT_STEPS, "the resume did not start "
          "from step 8 and finish")
    check(same_params, "the resumed params differ from the uninterrupted "
          "run's")
    check(same_tail and same_head, "the losses differ from the "
          "uninterrupted run's")
    for m, r in (("uninterrupted", base), ("preempted", kill),
                 ("resumed", res)):
        n = r["steps_run"]
        c = r["launches"]
        check(c["lstm_scan"] == c["lstm_scan_bwd"] == 4 * n,
              f"K1/K2 did not launch 4 times a step in the {m} child")
        check(c["lstm_scan_plain"] == c["lstm_scan_bwd_plain"] == 0,
              f"a plain LSTM scan ran in the {m} child")
        check(not any(t.startswith("etl-") or t == "async-prefetch"
                      for t in r["threads"]),
              f"input threads outlived the {m} child's fit: {r['threads']}")
    for r in (base, kill, res):
        r.pop("params")
    return {"uninterrupted": base, "preempted": kill, "resumed": res,
            "on_disk_after_kill": on_disk, "resumed_from": k,
            "reexec_to_first_step_s": reexec_s, "launches": launches}


def write_idx(path: str, arr: np.ndarray) -> None:
    """An idx file of ubyte data."""
    with open(path, "wb") as f:
        f.write(bytes([0, 0, 0x08, arr.ndim]))
        for d in arr.shape:
            f.write(int(d).to_bytes(4, "big"))
        f.write(np.ascontiguousarray(arr, np.uint8).tobytes())


def phase_runtime_early_stopping(seed: int, dev, tmp: str) -> dict:
    print(f"== (b) LeNet-5 under EarlyStoppingTrainer, fed by the native "
          f"host feed (InputPipeline.from_native), batch {LENET_BATCH}, "
          f"{ES_TRAIN} training rows, {ES_HELD} held out ==")
    imgs, lbls = _synthetic_mnist(ES_TRAIN + ES_HELD, seed)
    paths = {}
    sl_of = {"train": slice(0, ES_TRAIN), "held": slice(ES_TRAIN, None)}
    for split, sl in sl_of.items():
        paths[split] = (os.path.join(tmp, f"{split}-images-idx3-ubyte"),
                        os.path.join(tmp, f"{split}-labels-idx1-ubyte"))
        write_idx(paths[split][0], imgs[sl])
        write_idx(paths[split][1], lbls[sl])
    t0 = time.perf_counter()
    raw = native.read_idx(paths["train"][0], normalize=False)
    read_s = time.perf_counter() - t0
    lib = native.loaded_path()
    check(lib is not None and os.path.realpath(lib).startswith(
        os.path.realpath(str(native.BUILD_DIR)) + os.sep),
        f"the native library loaded is not the port's build ({lib})")
    check(np.array_equal(raw, imgs[:ES_TRAIN].astype(np.float32)),
          "read_idx did not give back the images written")
    data = {}
    for split in ("train", "held"):
        x = native.read_idx(paths[split][0])
        check(np.array_equal(x, native._read_idx_py(paths[split][0], True)),
              "read_idx disagrees with its plain version")
        lab = native.read_idx(paths[split][1], normalize=False)
        check(np.array_equal(lab, lbls[sl_of[split]].astype(np.float32)),
              "the labels read back differ")
        data[split] = (x.reshape(-1, 28, 28, 1),
                       np.eye(10, dtype=np.float32)[lab.astype(np.int64)])
    print(f"native library {os.path.relpath(lib, REPO_ROOT)}; read_idx of "
          f"{ES_TRAIN} images in {read_s * 1e3:.1f} ms, equal to what was "
          f"written")
    (xt, yt), (xh, yh) = data["train"], data["held"]
    net = build_lenet5(device=dev)
    pipe = InputPipeline.from_native(xt, yt, LENET_BATCH, epochs=1, seed=seed,
                                     capacity=4, workers=RT_WORKERS,
                                     prefetch=RT_PREFETCH, device=dev,
                                     shard=None)
    held = lambda: ListDataSetIterator(xh, yh, LENET_BATCH)  # noqa: E731
    saver = es_mod.CheckpointManagerSaver(os.path.join(tmp, "es"),
                                          keep_last=2)
    cfg = (es_mod.EarlyStoppingConfiguration.builder()
           .score_calculator(es_mod.DataSetLossCalculator(held()))
           .epoch_termination_conditions(
               es_mod.MaxEpochsTerminationCondition(ES_EPOCHS),
               es_mod.ScoreImprovementEpochTerminationCondition(1))
           .model_saver(saver).save_last_model(True).build())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = es_mod.EarlyStoppingTrainer(cfg, net, pipe, device=dev).fit()
    es_s = time.perf_counter() - t0
    best = saver.get_best_model()
    best_again = es_mod.DataSetLossCalculator(held()).calculate_score(best)
    scores = result.score_vs_epoch
    print(f"early stopping: {result.termination_reason} "
          f"({result.termination_details}) after {result.total_epochs} "
          f"epochs in {es_s:.2f} s; held-out scores {scores}; best epoch "
          f"{result.best_model_epoch}, score {result.best_model_score:.6f}; "
          f"the restored best model scores {best_again:.6f} "
          f"(tol {TOL_ES_SCORE})")
    check(result.termination_reason == "epoch"
          and 1 <= result.total_epochs <= ES_EPOCHS,
          f"early stopping ended by {result.termination_reason}")
    check(all(np.isfinite(list(scores.values()))), "a score is not finite")
    check(result.best_model_score == min(scores.values())
          and scores[result.best_model_epoch] == result.best_model_score,
          "the best epoch is not the lowest score")
    check(abs(best_again - result.best_model_score) <= TOL_ES_SCORE,
          "the restored best model's score differs from the best score")
    n_batches = ES_TRAIN // LENET_BATCH

    def through_pipeline():
        for ds in pipe:
            net.fit(ds.features, ds.labels)

    xs = [torch.from_numpy(xt[i:i + LENET_BATCH]).to(dev)
          for i in range(0, ES_TRAIN, LENET_BATCH)]
    ys = [torch.from_numpy(yt[i:i + LENET_BATCH]).to(dev)
          for i in range(0, ES_TRAIN, LENET_BATCH)]

    def direct():
        for a, b in zip(xs, ys):
            net.fit(a, b)

    pipe_ms = wall_ms(through_pipeline, 1) / n_batches
    direct_ms = wall_ms(direct, 1) / n_batches
    pipe_ms2 = wall_ms(through_pipeline, 1) / n_batches
    direct_ms2 = wall_ms(direct, 1) / n_batches
    pipe_ms, direct_ms = min(pipe_ms, pipe_ms2), min(direct_ms, direct_ms2)
    snap = pipe.pipeline_stats.snapshot()
    print(f"samples/s through the native feed and the pipeline "
          f"{LENET_BATCH / pipe_ms * 1e3:.1f} ({pipe_ms:.3f} ms a step), "
          f"direct fit of tensors on the card "
          f"{LENET_BATCH / direct_ms * 1e3:.1f} ({direct_ms:.3f} ms a "
          f"step; the better of two passes each); stall_fraction over the "
          f"pipeline's passes {snap['stall_fraction']}")
    saver.manager.close()
    return dict(scores=scores, best_epoch=result.best_model_epoch,
                best_score=result.best_model_score,
                restored_best_score=best_again,
                termination=result.termination_details,
                epochs=result.total_epochs, early_stopping_s=es_s,
                native_library=os.path.relpath(lib, REPO_ROOT),
                read_idx_ms=read_s * 1e3,
                pipeline_samples_per_s=LENET_BATCH / pipe_ms * 1e3,
                direct_samples_per_s=LENET_BATCH / direct_ms * 1e3,
                pipeline_ms_per_step=pipe_ms, direct_ms_per_step=direct_ms,
                pipeline_stats=snap)


def ip_conf():
    return (NeuralNetConfiguration.builder().seed(7).learning_rate(0.01)
            .updater("adam").list()
            .layer(0, L.DenseLayer(n_in=IP_F, n_out=32, activation="relu"))
            .layer(1, L.OutputLayer(n_in=32, n_out=IP_C,
                                    activation="softmax",
                                    loss_function="mcxent"))
            .build())


def phase_runtime_bench_legs(seed: int, dev, tmp: str) -> dict:
    print(f"== (c) bench.py's input_pipeline leg ({IP_BATCH} x {IP_BATCHES} "
          f"rows of {IP_F} features, NormalizerStandardize, MLP "
          f"{IP_F}-32-{IP_C}) and checkpoint_overhead leg (MLP "
          f"784-256-256-10, batch {CK_BATCH}) ==")
    path = os.path.join(tmp, "data.csv")
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(IP_BATCH * IP_BATCHES):
            f.write(",".join(f"{v:.6f}" for v in rng.standard_normal(IP_F))
                    + f",{int(rng.integers(0, IP_C))}\n")
    naive_it = lambda: RecordReaderDataSetIterator(  # noqa: E731
        CSVRecordReader(path), IP_BATCH, label_index=IP_F,
        num_possible_labels=IP_C)
    norm = NormalizerStandardize().fit(naive_it())
    nets = {m: MultiLayerNetwork(ip_conf(), device=dev).init()
            for m in ("naive", "pipeline")}
    stats = {}

    def run(mode):
        net = nets[mode]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "naive":  # parse, assemble, normalize, fit: one thread
            for ds in naive_it():
                norm.transform(ds)
                net.fit(ds.features, ds.labels)
        else:
            pipe = InputPipeline.from_reader(
                CSVRecordReader(path), IP_BATCH, label_index=IP_F,
                num_possible_labels=IP_C, normalizer=norm,
                workers=RT_WORKERS, prefetch=RT_PREFETCH, device=dev,
                shard=None)
            for ds in pipe:
                net.fit(ds.features, ds.labels)
            stats.update(pipe.pipeline_stats.snapshot())
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run("naive")
    run("pipeline")
    same = all(torch.equal(a, b) for a, b in zip(
        lowprec.tree_leaves(nets["naive"].params),
        lowprec.tree_leaves(nets["pipeline"].params)))
    pairs = [(run("naive"), run("pipeline")) for _ in range(3)]
    n_s, p_s = sorted(pairs, key=lambda r: r[0] / r[1])[1]
    rows = IP_BATCH * IP_BATCHES
    print(f"input pipeline: after one pass each from one initialization "
          f"the params are torch.equal: {same}; naive feed "
          f"{rows / n_s:.1f} samples/s, InputPipeline.from_reader "
          f"{rows / p_s:.1f} samples/s (the median of 3 interleaved "
          f"pairs); stall_fraction {stats['stall_fraction']}, producer "
          f"stall {stats['producer_stall_seconds']} s")
    check(same, "the pipeline's params differ from the naive feed's")

    conf = (NeuralNetConfiguration.builder().seed(7).learning_rate(0.01)
            .updater("adam").list()
            .layer(0, L.DenseLayer(n_in=784, n_out=256, activation="relu"))
            .layer(1, L.DenseLayer(n_in=256, n_out=256, activation="relu"))
            .layer(2, L.OutputLayer(n_in=256, n_out=10,
                                    activation="softmax",
                                    loss_function="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device=dev).init()
    x = torch.from_numpy(rng.standard_normal((CK_BATCH, 784)).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, CK_BATCH)]).to(dev)
    net.fit(x, y)
    cadence = max(1, CK_STEPS // 6)

    def ck_run(m, where):
        mgr = None
        if m != "none":
            mgr = pres.CheckpointManager(where, async_save=(m == "async"),
                                         keep_last=2)
        blocks = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(1, CK_STEPS + 1):
            net.fit(x, y)
            if mgr is not None and s % cadence == 0:
                tb = time.perf_counter()
                mgr.save(net, step=s, block=(m == "sync"))
                blocks.append(time.perf_counter() - tb)
        if mgr is not None:
            mgr.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = dict(mgr.stats) if mgr is not None else {}
        if mgr is not None:
            mgr.close()
        return wall, blocks, st

    modes = ("none", "sync", "async")
    for m in modes:
        ck_run(m, os.path.join(tmp, f"ck_warm_{m}"))
    reps = [{m: ck_run(m, os.path.join(tmp, f"ck_{r}_{m}")) for m in modes}
            for r in range(3)]
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    wall = {m: med([r[m][0] for r in reps]) for m in modes}
    block = {m: med([1e3 * sum(r[m][1]) / max(1, len(r[m][1]))
                     for r in reps]) for m in ("sync", "async")}
    st = reps[-1]["sync"][2]
    ckpt_mb = st["bytes"] / max(1, st["saves"]) / 1e6
    print(f"checkpoint overhead: a checkpoint is {ckpt_mb:.3f} MB; the loop "
          f"stalls {block['sync']:.2f} ms per sync save and "
          f"{block['async']:.2f} ms per async save (medians of 3 "
          f"interleaved reps of {CK_STEPS} steps, a save every {cadence}); "
          f"wall per step none/sync/async "
          f"{wall['none'] / CK_STEPS * 1e3:.3f}/"
          f"{wall['sync'] / CK_STEPS * 1e3:.3f}/"
          f"{wall['async'] / CK_STEPS * 1e3:.3f} ms; async skipped busy "
          f"{reps[-1]['async'][2].get('skipped_busy', 0)}")
    return dict(input_pipeline=dict(
        params_equal=same, naive_samples_per_s=rows / n_s,
        pipeline_samples_per_s=rows / p_s, stats=stats),
        checkpoint=dict(ckpt_mb=ckpt_mb, sync_stall_ms=block["sync"],
                        async_stall_ms=block["async"],
                        wall_ms_per_step={m: wall[m] / CK_STEPS * 1e3
                                          for m in modes},
                        writer_mb_per_s=st["bytes"] / 1e6
                        / max(1e-9, st["write_s"])))


def phase_runtime(seed: int, dev) -> dict:
    print("== the training runtime: record readers, InputPipeline and its "
          "stager, the native host feed, ResilientTrainer with async "
          "checkpoints, early stopping (strict f32) ==")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = {"resilient": phase_runtime_resilient(seed, tmp),
               "early_stopping": phase_runtime_early_stopping(seed, dev, tmp),
               "bench_legs": phase_runtime_bench_legs(seed, dev, tmp)}
    out["phase_s"] = time.perf_counter() - t0
    print(f"runtime phase: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# distributed training (PR 19): MoE, Megatron, pipeline, data parallelism,
# the sharded checkpoint, on world-1 NCCL groups
# ---------------------------------------------------------------------------

MOE_KW = dict(moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
              moe_aux_coef=1e-2)
MOE_BATCH, MOE_FITS, MOE_MULTI, MOE_GEN = 16, 10, 4, 32
MESH_LAYERS, MESH_BATCH, MESH_MICRO = 2, 8, 4
TOL_PIPE = 1e-4  # the pipeline against accumulation: loss and params, abs
AVG_WORKERS, AVG_FREQ, AVG_ROUNDS = 4, 5, 2
PW_BATCH = 128


def moe_cfg(seed: int, **kw) -> TransformerConfig:
    """The bench transformer (``bench.py:356-367``) with 8 experts a
    layer, top 2, capacity factor 1.25, aux coefficient 1e-2."""
    return dataclasses.replace(lm_cfg(seed), **dict(MOE_KW, **kw))


def moe_group(name: str) -> str:
    """A profiler kernel's group in the MoE step."""
    low = name.lower()
    if "flash_fwd" in name:
        return "K4 flash_fwd_tc<bf16>"
    if "flash_bwd" in name:
        return "K7 flash_bwd"
    if "gemm" in low or "xmma" in low or "nvjet" in low or "cutlass" in low:
        return "GEMMs (experts, projections, head)"
    if any(s in low for s in ("index", "gather", "scatter", "cumsum",
                              "argmax", "scan", "one_hot")):
        return "routing, gather and scatter"
    return "other kernels"


def dist_moe(seed: int, dev):
    """(a) The MoE TransformerLM at full width through K4/K7."""
    cfg = moe_cfg(seed)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    lm = TransformerLM(cfg, device=dev)
    n_params = sum(x.numel() for x in lm_mod.tree_leaves(lm.params))
    print(f"(a) MoE TransformerLM: d_model {cfg.d_model}, {cfg.n_layers} "
          f"layers, {cfg.n_heads} heads, {cfg.moe_experts} experts of d_ff "
          f"{cfg.d_ff} a layer, top {cfg.moe_top_k}, capacity factor "
          f"{cfg.moe_capacity_factor}, aux {cfg.moe_aux_coef}, bf16 compute "
          f"with f32 masters, {n_params} parameters; {MOE_FITS} fits then "
          f"fit_batches of {MOE_MULTI} at {MOE_BATCH} x {LM_T}")
    mk = lambda s, k=None: tuple(t[..., :MOE_BATCH, :] for t in  # noqa
                                 lm_batch(s, dev, k))
    batches = [mk(seed + 500 + i) for i in range(MOE_FITS)]
    xs, ys = mk(seed + 600, MOE_MULTI)
    kernels = (flash_attention, flash_bwd, flash_attention_plain,
               flash_block_bwd)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(lm.fit(x, y)) for x, y in batches]
    multi = [float(v) for v in lm.fit_batches(xs, ys)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in kernels}
    steps = MOE_FITS + MOE_MULTI
    peak = torch.cuda.max_memory_allocated() - held
    print("loss per fit: " + " ".join(f"{v:.4f}" for v in losses)
          + "; fit_batches: " + " ".join(f"{v:.4f}" for v in multi))
    check(all(np.isfinite(losses + multi)), "an MoE loss is not finite")
    check(np.mean(multi) < losses[0] and multi[-1] < losses[0],
          "the MoE loss did not fall")
    check(counts["flash_attention"] == counts["flash_bwd"]
          == cfg.n_layers * steps,
          f"K4 and K7 did not launch once per layer per MoE step: {counts}")
    check(counts["flash_attention_plain"] == 0
          and counts["flash_block_bwd"] == 0,
          "a plain flash version ran in the MoE steps")
    stats = {}
    with torch.inference_mode():
        _, aux = lm_mod.forward(lm.compute_params, batches[0][0], cfg,
                                stats=stats)
    drop = int(stats["dropped"]) / stats["slots"]
    x, y = batches[0]
    step_ms = time_ms(lambda: lm.fit(x, y), iters=3, warmup=1)
    busy, rows = profile_ms(lambda: lm.fit(x, y), n=2)
    adam_busy, _ = profile_ms(lambda: lm_mod._adam_update(
        lm.params, lm.opt["m"], lm.opt,
        torch.tensor(cfg.learning_rate, device=dev)), n=2)
    groups = {}
    for ms_, _, name in rows:
        g = moe_group(name)
        groups[g] = groups.get(g, 0.0) + ms_
    groups["Adam (its kernels, profiled alone)"] = adam_busy
    groups["other kernels"] = groups.get("other kernels", 0.0) - adam_busy
    groups["host gaps (wall - kernels)"] = step_ms - busy
    tok_s = MOE_BATCH * LM_T / step_ms * 1e3
    print(f"MoE fit: {step_ms:.3f} ms per step, {tok_s:.0f} tokens/s; "
          f"kernels {busy:.3f} ms ({busy / step_ms:.1%}): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in groups.items()))
    for ms_, calls, name in rows[:10]:
        print(f"  {ms_:8.4f} ms  x{calls:<3d} {name[:100]}")
    print(f"{steps} steps in {wall:.3f} s (first calls included); peak "
          f"device memory {peak / 2**30:.3f} GiB above the earlier phases; "
          f"token slots dropped by capacity {drop:.4%} "
          f"({int(stats['dropped'])} of {stats['slots']}); aux loss "
          f"{float(aux):.5f}")
    prompt = mk(seed + 700)[0][:2, :64]
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    out = lm.generate(prompt, MOE_GEN, temperature=0.8, seed=seed,
                      use_cache=True)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check(out.shape == (2, MOE_GEN) and bool((out >= 0).all())
          and bool((out < cfg.vocab_size).all()),
          f"MoE generate gave {tuple(out.shape)} tokens out of range")
    check(flash_attention.launches == cfg.n_layers
          and flash_attention_plain.launches == 0,
          "MoE generate's prefill did not run K4 once per layer")
    print(f"MoE generate: 2 prompts of 64, {MOE_GEN} new tokens in "
          f"{gen_s:.3f} s (prefill through K4, decode steps through the "
          "no-drop MoE FFN)")
    return lm, counts, {"steps": steps, "loss_per_fit": losses,
                        "fit_batches_losses": multi, "wall_s": wall,
                        "launches": counts, "step_ms": step_ms,
                        "tokens_per_s": tok_s, "peak_memory_bytes": peak,
                        "dropped_share": drop, "aux": float(aux),
                        "generate_s": gen_s, "n_params": n_params,
                        "profile": dict(device_busy_ms=busy, groups=groups)}


def dist_mesh_steps(seed: int, dev):
    """(b) Megatron (data x model x expert) and pipeline steps of the MoE
    LM at full width and 2 layers, strict f32, on world-1 NCCL groups."""
    from deeplearning4j_tpu_torch.parallel.mesh import device_mesh

    cfg = moe_cfg(seed, n_layers=MESH_LAYERS, dtype_policy="strict")
    torch.cuda.empty_cache()
    params = lm_mod.init_params(cfg, device=dev)
    x, y = lm_batch(seed + 800, dev)
    x, y = x[:MESH_BATCH], y[:MESH_BATCH]
    kernels = (flash_attention, flash_bwd, flash_attention_plain,
               flash_block_bwd)

    def run(step, p):
        for fn in kernels:
            fn.launches = 0
        out = step(p, lm_mod.init_opt_state(p), x, y)
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in kernels}
        ms_ = time_ms(lambda: step(p, lm_mod.init_opt_state(p), x, y),
                      iters=2, warmup=0)
        return out, counts, ms_

    mesh = device_mesh((1, 1, 1), ("data", "model", "expert"))
    (p0, _, l0), c0, plain_ms = run(lm_mod.make_train_step(cfg), params)
    (p1, _, l1), c1, mega_ms = run(lm_mod.make_train_step(cfg, mesh),
                                   lm_mod.shard_params(params, cfg, mesh))
    equal = torch.equal(l0, l1) and all(
        torch.equal(a, b) for a, b in zip(lm_mod.tree_leaves(p0),
                                          lm_mod.tree_leaves(p1)))
    del p0, p1
    pipe = device_mesh((1,), ("pipe",))
    cfg_a = dataclasses.replace(cfg, accum_steps=MESH_MICRO)
    (pa, _, la), ca, accum_ms = run(lm_mod.make_train_step(cfg_a), params)
    (pp, _, lp), cp, pipe_ms = run(lm_mod.make_pipeline_train_step(
        cfg, pipe, n_micro=MESH_MICRO), lm_mod.shard_params(params, cfg,
                                                           pipe))
    pipe_err = max([abs(float(la) - float(lp))] + [
        (a - b).abs().max().item() for a, b in
        zip(lm_mod.tree_leaves(pa), lm_mod.tree_leaves(pp))])
    del pa, pp, params
    print(f"(b) {MESH_LAYERS}-layer MoE LM, strict f32, batch {MESH_BATCH} "
          f"x {LM_T}: plain step {plain_ms:.3f} ms; DP x TP x EP (1x1x1) "
          f"step {mega_ms:.3f} ms, torch.equal to the plain step: {equal}; "
          f"accumulation of {MESH_MICRO} {accum_ms:.3f} ms; GPipe of "
          f"{MESH_MICRO} microbatches {pipe_ms:.3f} ms, largest |loss or "
          f"param - accumulation's| {pipe_err:.3e}; launches plain {c0}, "
          f"Megatron {c1}, pipeline {cp}")
    check(equal, "the world-1 Megatron step is not torch.equal to the "
          "plain step")
    check(pipe_err <= TOL_PIPE, f"the pipeline step is {pipe_err:.3e} "
          f"from accumulation (bar {TOL_PIPE})")
    for name, c in (("Megatron", c1), ("pipeline", cp)):
        check(c["flash_attention"] == c["flash_bwd"] == MESH_LAYERS
              * (MESH_MICRO if name == "pipeline" else 1)
              and c["flash_attention_plain"] == 0
              and c["flash_block_bwd"] == 0,
              f"K4/K7 did not launch in the {name} step: {c}")
    return {"plain_ms": plain_ms, "megatron_ms": mega_ms,
            "accum_ms": accum_ms, "pipeline_ms": pipe_ms,
            "megatron_equal": equal, "pipeline_max_err": pipe_err,
            "launches": {"plain": c0, "megatron": c1, "accum": ca,
                         "pipeline": cp}}


def avg_data(seed: int, dev):
    """The char-RNN's rows for the averaging rounds: AVG_ROUNDS splits of
    AVG_WORKERS x TRAIN_BATCH x AVG_FREQ sequences of SEQ one-hot
    characters of the seeded Markov text."""
    n = AVG_ROUNDS * AVG_WORKERS * TRAIN_BATCH * AVG_FREQ
    text = markov_text(seed, n * SEQ + 1, [chr(32 + i) for i in
                                           range(VOCAB)])
    ids = np.frombuffer(text.encode("ascii"), np.uint8).astype(np.int64) - 32
    eye = np.eye(VOCAB, dtype=np.float32)
    x = eye[ids[:n * SEQ].reshape(n, SEQ)]
    y = eye[ids[1:n * SEQ + 1].reshape(n, SEQ)]
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def dist_data_parallel(seed: int, dev, data_group):
    """(c) ParallelWrapper (ResNet-50), the averaging master, distributed
    early stopping and the evaluator."""
    from deeplearning4j_tpu_torch.earlystopping.distributed import (
        DistributedEarlyStoppingTrainer,
    )
    from deeplearning4j_tpu_torch.parallel import training_master as ptm
    from deeplearning4j_tpu_torch.parallel.data_parallel import (
        ParallelWrapper,
        average_trees,
    )

    torch.cuda.empty_cache()
    x, y = image_batch(seed + 900, PW_BATCH, RESNET_SIZE, 1000, dev)
    nets = [build_resnet50(input_size=RESNET_SIZE, device=dev,
                           learning_rate=RESNET_LR) for _ in range(2)]
    # the pair compared bit for bit runs cuDNN's deterministic algorithms
    # (its default backward-filter ones may add in any order)
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        t0 = time.perf_counter()
        l_serial = nets[0].fit(x, y)
        torch.cuda.synchronize()
        serial_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        l_pw = ParallelWrapper(nets[1], group=data_group,
                               device=dev).fit(x, y)
        torch.cuda.synchronize()
        pw_s = time.perf_counter() - t0
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    pw_equal = torch.equal(l_serial, l_pw) and all(
        torch.equal(a, b) for a, b in zip(lm_mod.tree_leaves(nets[0].params),
                                          lm_mod.tree_leaves(nets[1].params)))
    del nets
    print(f"(c) ParallelWrapper over the world-1 'data' group, ResNet-50 at "
          f"{RESNET_SIZE}, batch {PW_BATCH}, cuDNN deterministic: "
          f"{pw_s:.3f} s (net.fit {serial_s:.3f} s, first calls), "
          f"torch.equal to net.fit: {pw_equal}")
    check(pw_equal, "the ParallelWrapper step differs from net.fit")
    torch.cuda.empty_cache()

    ax, ay = avg_data(seed, dev)
    conf = char_rnn_conf(VOCAB, lstm_size=LSTM_H, num_layers=2, seed=seed,
                         tbptt_length=TBPTT, learning_rate=TRAIN_LR)
    new_net = lambda: MultiLayerNetwork(conf, device=dev).init(  # noqa
        input_shape=(1, VOCAB))
    net, ref = new_net(), new_net()
    master = ptm.ParameterAveragingTrainingMaster(
        num_workers=AVG_WORKERS, batch_size_per_worker=TRAIN_BATCH,
        averaging_frequency=AVG_FREQ, repartition=ptm.Repartition.NEVER,
        collect_training_stats=True, device=dev)
    kernels = (lstm_scan, lstm_scan_plain, lstm_scan_bwd,
               lstm_scan_bwd_plain)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    master.execute_training(net, [DataSet(ax, ay)])
    torch.cuda.synchronize()
    avg_s = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in kernels}
    per_round = AVG_WORKERS * TRAIN_BATCH * AVG_FREQ
    t0 = time.perf_counter()
    for r in range(AVG_ROUNDS):
        workers = []
        for w in range(AVG_WORKERS):
            wn = ref.clone()
            for i in range(AVG_FREQ):
                lo = r * per_round + i * AVG_WORKERS * TRAIN_BATCH \
                    + w * TRAIN_BATCH
                wn.fit(ax[lo:lo + TRAIN_BATCH], ay[lo:lo + TRAIN_BATCH])
            workers.append(wn)
        ref.params = average_trees([wn.params for wn in workers])
        ref.updater_state = average_trees([wn.updater_state
                                           for wn in workers])
        ref.iteration = workers[0].iteration
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    avg_equal = all(torch.equal(a, b) for a, b in zip(
        lm_mod.tree_leaves(net.params) + lm_mod.tree_leaves(
            [u for u in net.updater_state]),
        lm_mod.tree_leaves(ref.params) + lm_mod.tree_leaves(
            [u for u in ref.updater_state]))
        if torch.is_tensor(a))
    fits = AVG_ROUNDS * AVG_WORKERS * AVG_FREQ
    samples = AVG_ROUNDS * per_round
    print(f"ParameterAveragingTrainingMaster: {AVG_WORKERS} in-process "
          f"workers, frequency {AVG_FREQ}, {AVG_ROUNDS} rounds of "
          f"{per_round} sequences of {SEQ} (char-RNN, 2 GravesLSTM x "
          f"{LSTM_H}, TBPTT {TBPTT}, RMSProp): {samples / avg_s:.1f} "
          f"samples/s against {samples / ref_s:.1f} for the explicit "
          f"reference's serial fits; torch.equal to four nets fitted on "
          f"their shards and averaged: {avg_equal}; launches {counts}")
    check(avg_equal, "the averaging master differs from its explicit "
          "reference")
    check(counts["lstm_scan"] == counts["lstm_scan_bwd"] == 4 * fits
          and counts["lstm_scan_plain"] == 0
          and counts["lstm_scan_bwd_plain"] == 0,
          f"K1/K2 did not launch 4 times per worker fit: {counts}")

    es_net = new_net()
    es_master = ptm.ParameterAveragingTrainingMaster(
        num_workers=AVG_WORKERS, batch_size_per_worker=TRAIN_BATCH,
        averaging_frequency=AVG_FREQ, device=dev)
    es_cfg = es_mod.EarlyStoppingConfiguration(
        epoch_terminations=[es_mod.MaxEpochsTerminationCondition(2)])
    t0 = time.perf_counter()
    res = DistributedEarlyStoppingTrainer(
        es_cfg, es_master, es_net, [DataSet(ax, ay)], device=dev).fit()
    es_s = time.perf_counter() - t0
    print(f"DistributedEarlyStoppingTrainer, MaxEpochs(2): {res.total_epochs}"
          f" epochs ({res.termination_reason}), best score "
          f"{res.best_model_score:.5f}, {es_s:.1f} s")
    check(res.total_epochs == 2 and res.best_model is not None,
          "distributed early stopping did not run its 2 epochs")
    data = [DataSet(ax[i:i + 64], ay[i:i + 64]) for i in range(0, 512, 64)]
    merged = ptm.DistributedEvaluator(num_shards=4).evaluate(net, data)
    serial = ptm.DistributedEvaluator(num_shards=1).evaluate(net, data)
    print(f"DistributedEvaluator over 4 shards: accuracy "
          f"{merged.accuracy():.5f}, serial {serial.accuracy():.5f}")
    check(merged.accuracy() == serial.accuracy()
          and merged.f1() == serial.f1(),
          "the merged evaluation differs from the serial one")
    return net, counts, {
        "pw_equal": pw_equal, "pw_s": pw_s, "fit_s": serial_s,
        "avg_equal": avg_equal, "avg_samples_per_s": samples / avg_s,
        "serial_samples_per_s": samples / ref_s, "launches": counts,
        "es_epochs": res.total_epochs, "es_s": es_s,
        "eval_accuracy": merged.accuracy(),
        "stats": master.get_training_stats().summary()}


def dist_checkpoint(lm: TransformerLM, net: MultiLayerNetwork, seed: int,
                    dev):
    """(d) save_lm / restore_lm of the MoE LM, and one sharded
    CheckpointManager save and restore_latest of the char-RNN."""
    from deeplearning4j_tpu_torch.utils import sharded_checkpoint as sc

    probe = lm_batch(seed + 950, dev)[0][:2, :256]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "moe_lm")
        t0 = time.perf_counter()
        sc.save_lm(path, lm)
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(path) for f in fs)
        want = lm.logits(probe)
        t0 = time.perf_counter()
        back = sc.restore_lm(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        same = torch.equal(back.logits(probe), want)
        del back
        mgr = pres.CheckpointManager(os.path.join(tmp, "ck"),
                                     backend="sharded", async_save=False)
        t0 = time.perf_counter()
        cpath = mgr.save(net, step=1)
        msave_s = time.perf_counter() - t0
        msize = sum(os.path.getsize(os.path.join(r, f))
                    for r, _, fs in os.walk(cpath) for f in fs)
        fresh = MultiLayerNetwork(net.conf, device=dev).init(
            input_shape=(1, VOCAB))
        t0 = time.perf_counter()
        info = mgr.restore_latest(fresh)
        mload_s = time.perf_counter() - t0
        mgr.close()
        msame = all(torch.equal(a, b) for a, b in zip(
            lm_mod.tree_leaves(fresh.params), lm_mod.tree_leaves(net.params)))
    print(f"(d) save_lm of the MoE LM: {size / 2**20:.1f} MB in "
          f"{save_s:.2f} s, restore_lm {load_s:.2f} s, logits torch.equal: "
          f"{same}; CheckpointManager(backend='sharded') of the char-RNN: "
          f"{msize / 2**20:.1f} MB saved in {msave_s:.3f} s, restore_latest "
          f"(step {info['step']}) in {mload_s:.3f} s, params equal: {msame}")
    check(same, "the restored MoE LM's logits differ")
    check(msame and info["step"] == 1, "the sharded manager's restore "
          "differs")
    return {"lm_mb": size / 2**20, "lm_save_s": save_s,
            "lm_restore_s": load_s, "manager_mb": msize / 2**20,
            "manager_save_s": msave_s, "manager_restore_s": mload_s}


def phase_distributed(seed: int, dev):
    """MoE, Megatron, the pipeline, the data-parallel trainers and the
    sharded checkpoint on world-1 NCCL groups (module docstring)."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.mesh import device_mesh

    print("== distributed training on world-1 NCCL groups ==")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        init_seq_group(os.path.join(tmp, "dist_store"), 0, 1,
                       backend="nccl")
        try:
            lm, moe_counts, moe = dist_moe(seed, dev)
            mesh = dist_mesh_steps(seed, dev)
            data = device_mesh((1,), ("data",)).group("data")
            net, lstm_counts, dp = dist_data_parallel(seed, dev, data)
            ckpt = dist_checkpoint(lm, net, seed, dev)
        finally:
            dist.destroy_process_group()
    del lm, net
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"distributed phase: {wall:.1f} s")
    counts = {"flash_attention": moe_counts["flash_attention"],
              "flash_bwd": moe_counts["flash_bwd"],
              "lstm_scan": lstm_counts["lstm_scan"],
              "lstm_scan_bwd": lstm_counts["lstm_scan_bwd"]}
    return counts, {"moe": moe, "mesh_steps": mesh, "data_parallel": dp,
                    "sharded_checkpoint": ckpt, "wall_s": wall}


# ---------------------------------------------------------------------------
# the serving fleet, autoscaling, the online plane and the elastic fleet
# ---------------------------------------------------------------------------

FLEET_HEARTBEAT_S = 1.0
FLEET_PROBES = 50               # single-row /predict calls, direct and routed
FLEET_KILL_AFTER, FLEET_CHAOS_REQS = 8, 48
FLEET_COUNTERS = (flash_attention, flash_attention_plain, paged_attention,
                  paged_attention_plain, lstm_scan, lstm_scan_plain,
                  lstm_scan_bwd, lstm_scan_bwd_plain, sgns_step,
                  sgns_step_plain)
ONLINE_ROUNDS, ONLINE_BATCHES = 3, 4     # ContinuousTrainer: 4 batches a round
ELASTIC_WORKERS, ELASTIC_ROUNDS, ELASTIC_ROWS = 4, 4, 48
FLEET_W2V_SENTENCES = 1000      # the topic corpus's first sentences


def fleet_counts():
    return {fn.__name__: fn.launches for fn in FLEET_COUNTERS}


def fleet_zero():
    for fn in FLEET_COUNTERS:
        fn.launches = 0


def char_rows(seed: int, n: int):
    """``n`` /predict payloads of 1-MAX_ROWS one-hot rows of SEQ steps."""
    rng = np.random.default_rng(seed)
    eye = np.eye(VOCAB, dtype=np.float32)
    return [eye[rng.integers(0, VOCAB, (int(rng.integers(1, MAX_ROWS + 1)),
                                        SEQ))] for _ in range(n)]


def predict_bodies(url: str, rows, model: str = "char", clients: int = 1):
    """(raw answer bodies, wall s) of /predict calls naming ``model``;
    every answer HTTP 200."""
    t0 = time.perf_counter()
    call = lambda x: _call(url, "/predict", {"batch": x.tolist(),
                                             "model": model})
    with ThreadPoolExecutor(clients) as ex:
        answers = list(ex.map(call, rows))
    wall = time.perf_counter() - t0
    for status, _, body in answers:
        check(status == 200, f"/predict HTTP {status}: {body[:200]}")
    return [body for _, _, body in answers], wall


def add_char_record(eng, net) -> None:
    """The char-RNN as the record "char" beside the engine's default,
    warmed over the bucket ladder."""
    eng.registry.load("char", model=net)
    eng.registry.warmup("char", max_batch=eng.max_batch,
                        sample_row=np.zeros((SEQ, VOCAB), np.float32))


def warm_lm(url: str, reqs, cfg) -> None:
    """One short request per admission width (first-call costs out of the
    timed bursts, as in ``phase_serve``)."""
    first = {}
    for r in reqs:
        k = min(len(r["tokens"][0]), cfg.max_len - r["n_new"])
        first.setdefault(min(max(bucket_size(k), k), cfg.max_len), r)
    for r in first.values():
        _post(url, dict(r, n_new=2, temperature=0.0))


def wait_until(cond, timeout: float, what: str) -> float:
    """Seconds until ``cond()`` held (raises past ``timeout``)."""
    t0 = time.monotonic()
    while not cond():
        check(time.monotonic() - t0 < timeout, f"timed out: {what}")
        time.sleep(0.02)
    return time.monotonic() - t0


def fleet_threads(lm, net, reqs, seed: int, dev) -> dict:
    """(a) two thread replicas of the bench LM (+ the char-RNN record)
    behind a FleetRouter against one engine."""
    from deeplearning4j_tpu_torch.resilience import (
        RouterChaos,
        RouterChaosConfig,
    )
    from deeplearning4j_tpu_torch.serving.fleet import ServingFleet

    cfg = lm.cfg
    nb = kv_arena_blocks(cfg, BT, budget_bytes=KV_BUDGET, params=lm.params)
    rows = char_rows(seed + 20, N_PREDICT)
    solo = ServingEngine(lm, kv_blocks=nb, device=dev).start()
    try:
        add_char_record(solo, net)
        warm_lm(solo.url, reqs, cfg)
        toks_solo, wall_solo = burst(solo, reqs)
        seq_solo, _ = predict_bodies(solo.url, rows)
        par_solo, pwall_solo = predict_bodies(solo.url, rows, clients=N_CLIENTS)
        direct = [predict_bodies(solo.url, rows[i % 4:i % 4 + 1])[1]
                  for i in range(FLEET_PROBES)]
    finally:
        solo.stop()
    gen = sum(len(t) for t in toks_solo)
    fleet = ServingFleet(model=lm, replicas=2, heartbeat_s=FLEET_HEARTBEAT_S,
                         engine_kwargs={"kv_blocks": nb}, device=dev).start()
    out = {"kv_blocks_per_replica": nb}
    try:
        for eng in fleet.engines().values():
            add_char_record(eng, net)
            warm_lm(eng.url, reqs, cfg)
        wait_until(lambda: len(fleet.router.signals()["ready_replicas"]) == 2,
                   60, "two ready replicas")
        fleet_zero()
        toks, wall = burst(fleet, reqs)
        gen_counts = fleet_counts()
        check(toks == toks_solo, "a /generate transcript through the router "
              "differs from one engine's")
        per_replica = {rid: eng.stats.snapshot()["generated_tokens"]
                       for rid, eng in fleet.engines().items()}
        print(f"(a) /generate: {len(toks)} transcripts through the router "
              f"equal to one engine's; {gen / wall:.1f} tokens/s through "
              f"the router beside {gen / wall_solo:.1f} on one engine; "
              f"tokens by replica {per_replica}; launches {gen_counts}")
        check(gen_counts["flash_attention"] > 0
              and gen_counts["paged_attention"] > 0,
              "K4 or K6 was not launched by the fleet's /generate")
        check(gen_counts["flash_attention_plain"] == 0
              and gen_counts["paged_attention_plain"] == 0,
              "a plain attention ran in the fleet")
        fleet_zero()
        seq, _ = predict_bodies(fleet.url, rows)
        check(seq == seq_solo, "a /predict answer through the router is not "
              "byte-equal to one engine's")
        par, pwall = predict_bodies(fleet.url, rows, clients=N_CLIENTS)
        err = max(float(np.abs(np.asarray(json.loads(a)["outputs"])
                               - np.asarray(json.loads(b)["outputs"])).max())
                  for a, b in zip(par, par_solo))
        check(err <= TOL_PREDICT, "a concurrent /predict answer through the "
              "router disagrees with one engine's")
        pred_counts = fleet_counts()
        check(pred_counts["lstm_scan"] > 0 and
              pred_counts["lstm_scan_plain"] == 0,
              "K1 was not launched (or the plain scan ran) for /predict")
        n_rows = sum(x.shape[0] for x in rows)
        routed = [predict_bodies(fleet.url, rows[i % 4:i % 4 + 1])[1]
                  for i in range(FLEET_PROBES)]
        added = (percentile(routed, 0.5) - percentile(direct, 0.5)) * 1e3
        print(f"(a) /predict: {N_PREDICT} sequential answers byte-equal to "
              f"one engine's, {N_CLIENTS} clients within {err:.2e}; "
              f"{n_rows / pwall:.1f} rows/s through the router beside "
              f"{n_rows / pwall_solo:.1f} on one engine; the router adds "
              f"{added:.3f} ms at p50 (single-row calls, "
              f"{percentile(direct, 0.5) * 1e3:.3f} ms direct); launches "
              f"{pred_counts}")
        # RouterChaos: r0 killed hard after FLEET_KILL_AFTER proxied calls
        chaos = RouterChaos(RouterChaosConfig(kill_replica={
            "replica": "r0", "after_proxied": FLEET_KILL_AFTER}))
        fleet.router.chaos = chaos
        kill = {}

        def watch():
            while fleet._handles["r0"].alive:
                time.sleep(0.002)
            kill["t"] = time.monotonic()
            while "r0" in fleet.router.signals()["ready_replicas"]:
                time.sleep(0.002)
            kill["ejected"] = time.monotonic()

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        chaos_rows = rows[:FLEET_CHAOS_REQS]
        got, _ = predict_bodies(fleet.url, chaos_rows, clients=4)
        watcher.join(timeout=30)
        check("ejected" in kill, "the killed replica was never ejected")
        err = max(float(np.abs(np.asarray(json.loads(a)["outputs"])
                               - np.asarray(json.loads(b)["outputs"])).max())
                  for a, b in zip(got, par_solo))
        check(err <= TOL_PREDICT, "an answer across the kill disagrees")
        snap = fleet.router.stats.snapshot()
        t0 = time.monotonic()
        fleet.restart_replica("r0")
        add_char_record(fleet.engines()["r0"], net)
        wait_until(lambda: "r0" in fleet.router.signals()["ready_replicas"],
                   60, "the respawned replica ready")
        respawn = time.monotonic() - t0
        print(f"(a) RouterChaos killed r0 after {FLEET_KILL_AFTER} proxied "
              f"calls: {len(got)} admitted /predict answered (HTTP 200, "
              f"within {err:.2e}), {snap['retries']} retried, "
              f"{snap['replica_failures']} replica failures; ejected "
              f"{kill['ejected'] - kill['t']:.3f} s after the kill, "
              f"respawned and ready in {respawn:.3f} s")
        out.update(
            generate={"requests": len(toks), "tokens": gen,
                      "router_tokens_per_s": gen / wall,
                      "engine_tokens_per_s": gen / wall_solo,
                      "tokens_by_replica": per_replica,
                      "launches": gen_counts},
            predict={"requests": len(rows), "rows": n_rows,
                     "router_rows_per_s": n_rows / pwall,
                     "engine_rows_per_s": n_rows / pwall_solo,
                     "router_added_p50_ms": added,
                     "direct_p50_ms": percentile(direct, 0.5) * 1e3,
                     "launches": pred_counts},
            chaos={"answered": len(got), "retries": snap["retries"],
                   "replica_failures": snap["replica_failures"],
                   "kill_to_eject_s": kill["ejected"] - kill["t"],
                   "respawn_s": respawn})
    finally:
        fleet.stop()
    return out, toks_solo, seq_solo, rows, nb


def fleet_processes(net, rows, seq_solo, tmp: str) -> dict:
    """(b) two OS-process replicas of the char-RNN zip on the card."""
    from deeplearning4j_tpu_torch.parallel.fleet import FileMembershipBoard
    from deeplearning4j_tpu_torch.serving.router import (
        FleetRouter,
        read_replica_addr,
    )

    zip_path = os.path.join(tmp, "char_rnn.zip")
    write_model(net, zip_path)
    fleet_dir = os.path.join(tmp, "fleet")
    os.makedirs(fleet_dir)
    env = dict(os.environ, PYTHONPATH=REPO_ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.monotonic()
    logs = {rid: os.path.join(tmp, f"replica-{rid}.log")
            for rid in ("p0", "p1")}
    procs = {rid: subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.serving.fleet",
         "--fleet-dir", fleet_dir, "--replica-id", rid, "--model-path",
         zip_path, "--heartbeat-s", str(FLEET_HEARTBEAT_S)],
        env=env, cwd=REPO_ROOT, stdout=subprocess.DEVNULL,
        stderr=open(logs[rid], "wb")) for rid in logs}
    router = None
    try:
        for rid, p in procs.items():
            def up(rid=rid, p=p):
                if p.poll() is not None:
                    with open(logs[rid], "rb") as f:
                        tail = f.read().decode(errors="replace")[-600:]
                    check(False, f"replica {rid} exited: {tail}")
                url = read_replica_addr(fleet_dir, rid)
                if url is None:
                    return False
                try:
                    return _call(url, "/health")[0] == 200
                except OSError:
                    return False
            wait_until(up, 180, f"replica {rid} up")
        boot = time.monotonic() - t0
        router = FleetRouter(board=FileMembershipBoard(
            fleet_dir, heartbeat_timeout=FLEET_HEARTBEAT_S), poll_s=0.2)
        router.start()
        wait_until(lambda: len(router.signals()["ready_replicas"]) == 2, 30,
                   "two process replicas routable")
        got, _ = predict_bodies(router.url, rows, model="default")
        check(got == seq_solo, "an OS-process replica's answer is not "
              "byte-equal to the thread fleet's")
        t0 = time.monotonic()
        procs["p1"].send_signal(signal.SIGTERM)
        check(procs["p1"].wait(timeout=60) == 0,
              "the SIGTERM'd replica did not exit 0")
        exit_s = time.monotonic() - t0
        gone = wait_until(lambda: sorted(router.describe_replicas())
                          == ["p0"], 30, "the goodbye seen by the router")
        check(read_replica_addr(fleet_dir, "p1") is None,
              "the goodbye left the address file")
        check(router.stats.snapshot()["breaker_opens"] == 0,
              "a goodbye voted a breaker")
        check(router.proxy_predict(json.dumps(
            {"batch": rows[0].tolist()}).encode())[0] == 200,
            "the survivor did not answer")
        t0 = time.monotonic()
        procs["p0"].kill()
        procs["p0"].wait(timeout=30)
        expiry = wait_until(lambda: not router.describe_replicas(), 30,
                            "the killed replica expired")
        print(f"(b) 2 OS-process replicas (python -m "
              f"deeplearning4j_tpu_torch.serving.fleet, the char-RNN zip) "
              f"up in {boot:.3f} s; {len(rows)} answers byte-equal to (a)'s; "
              f"SIGTERM: drained and exited in {exit_s:.3f} s, goodbye seen "
              f"{gone:.3f} s later; SIGKILL: expired after "
              f"{time.monotonic() - t0:.3f} s")
        return {"boot_s": boot, "answers": len(got),
                "sigterm_exit_s": exit_s, "goodbye_seen_s": gone,
                "sigkill_expiry_s": expiry}
    finally:
        if router is not None:
            router.stop()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def fleet_disaggregated(lm, reqs, toks_solo, nb: int, seed: int, dev) -> dict:
    """(c) a prefill-role and a decode-role replica; the width-2 tick."""
    from deeplearning4j_tpu_torch.serving.mesh import (
        concat_gather,
        mesh_paged_decode_step,
    )
    from deeplearning4j_tpu_torch.serving.router import FleetRouter

    greedy = [(r, t) for r, t in zip(reqs, toks_solo)
              if r["temperature"] == 0.0]
    pre = ServingEngine(lm, kv_blocks=nb, role="prefill", device=dev).start()
    dec = ServingEngine(lm, kv_blocks=nb, role="decode", device=dev).start()
    router = FleetRouter(replicas={
        "p0": {"url": pre.url, "role": "prefill"},
        "d0": {"url": dec.url, "role": "decode"}}).start()
    try:
        fleet_zero()
        t0 = time.perf_counter()
        for r, want in greedy:
            status, body = _post(router.url, r)
            check(status == 200 and _tokens(r, status, body) == want,
                  "a disaggregated transcript differs from one engine's")
        wall = time.perf_counter() - t0
        snap, ds, ps = (router.stats.snapshot(), dec.stats.snapshot(),
                        pre.stats.snapshot())
        counts = fleet_counts()
        check(snap["prefill_handoffs"] >= 1 and ds["prefix_imports"] >= 1,
              "no prefix was handed from the prefill to the decode replica")
        check(ps["generated_tokens"] == 0, "the prefill replica decoded")
        block = 2 * lm.cfg.n_layers * BT * lm.cfg.d_model * \
            torch.empty((), dtype=lm.cfg.compute_dtype).element_size()
        moved = ds["prefix_imports"] * block
        print(f"(c) {len(greedy)} greedy requests through a prefill + a "
              f"decode replica equal to one engine's in {wall:.3f} s: "
              f"{snap['prefill_handoffs']} handoffs, "
              f"{ds['prefix_imports']} blocks ({moved / 2**20:.1f} MiB) "
              f"adopted, {ds['prefix_hits']} prefix hits; launches {counts}")
    finally:
        router.stop()
        pre.stop()
        dec.stop()
    # the width-2 head-sharded tick against the dense tick, one process
    cfg = lm.cfg
    g = torch.Generator(device=dev).manual_seed(seed)
    m = cfg.max_len // BT
    shape = (cfg.n_layers, LANES * m + 1, BT, cfg.n_heads,
             cfg.d_model // cfg.n_heads)
    arena = {n: (torch.randn(shape, generator=g, device=dev) * 0.5).to(
        cfg.compute_dtype) for n in ("k", "v")}
    tables = (1 + torch.arange(LANES * m, device=dev, dtype=torch.int32)
              ).reshape(LANES, m)
    pos = torch.randint(0, cfg.max_len - 1, (LANES,), generator=g,
                        device=dev, dtype=torch.int32)
    tok = torch.randint(0, cfg.vocab_size, (LANES,), generator=g,
                        device=dev, dtype=torch.int32)
    hl = cfg.n_heads // 2
    shards = [(i, {n: a[:, :, :, i * hl:(i + 1) * hl].contiguous()
                   for n, a in arena.items()}) for i in range(2)]
    with torch.inference_mode():
        fleet_zero()
        got = mesh_paged_decode_step(lm.compute_params, shards, tok, pos,
                                     tables, cfg, 2, concat_gather)
        mesh_k6 = paged_attention.launches
        _, want = paged_decode_step(lm.compute_params, arena, tok, pos,
                                    tables, cfg)
        torch.cuda.synchronize()
    equal = torch.equal(got, want)
    written = all(torch.equal(s[n], arena[n][:, :, :, i * hl:(i + 1) * hl])
                  for i, s in shards for n in ("k", "v"))
    print(f"(c) the width-2 head-sharded tick ({hl} heads a shard, K6 on "
          f"each: {mesh_k6} launches for {cfg.n_layers} layers) at "
          f"{LANES} lanes: logits torch.equal to the dense tick's "
          f"{equal}; the shards' writes equal the dense arena's {written}")
    check(mesh_k6 == 2 * cfg.n_layers, "the sharded tick did not run K6 on "
          "each shard of each layer")
    check(paged_attention_plain.launches == 0,
          "the plain paged attention ran in the sharded tick")
    check(equal and written,
          "the width-2 head-sharded tick differs from the dense tick")
    del arena, shards
    counts["paged_attention"] += mesh_k6
    return {"greedy_requests": len(greedy), "wall_s": wall,
            "handoffs": snap["prefill_handoffs"],
            "blocks_adopted": ds["prefix_imports"], "bytes_adopted": moved,
            "prefix_hits": ds["prefix_hits"], "launches": counts,
            "sharded_tick": {"lanes": LANES, "heads_per_shard": hl,
                             "k6_launches": mesh_k6,
                             "logits_torch_equal": equal}}


def fleet_autoscale(lm, net, seed: int, dev) -> dict:
    """(d) a scripted /predict wave scales 1 -> 3 -> 1; placement."""
    from deeplearning4j_tpu_torch.resilience import (
        AutoscaleChaos,
        AutoscaleChaosConfig,
    )
    from deeplearning4j_tpu_torch.serving.autoscale import (
        FleetAutoscaler,
        ScaleConfig,
    )
    from deeplearning4j_tpu_torch.serving.fleet import ServingFleet
    from deeplearning4j_tpu_torch.serving.placement import (
        model_footprint,
        pack_models,
    )

    # 3 clients keep at most 3 requests queued: 2 a replica votes down
    # whenever the scripted wave is not on
    cfg = ScaleConfig(min_replicas=1, max_replicas=3, up_queue=10.0,
                      up_shed=0, window=1, down_queue=2.0, cooldown=0)
    fleet = ServingFleet(model=net, replicas=1, heartbeat_s=FLEET_HEARTBEAT_S,
                         device=dev).start()
    auto = FleetAutoscaler(fleet, config=cfg, chaos=AutoscaleChaos(
        AutoscaleChaosConfig(load_wave={"at_tick": 0, "ticks": 2,
                                        "queue_depth": 50})))
    rows = char_rows(seed + 30, 16)
    failures, answered = [], [0]
    stop = threading.Event()

    def hammer(i):
        while not stop.is_set():
            status, _, body = _call(fleet.url, "/predict",
                                    {"batch": rows[i % 16].tolist()})
            if status != 200:
                failures.append((status, body[:200]))
            answered[0] += 1
            i += 3

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(3)]
    ready = lambda n: len(fleet.router.signals()["ready_replicas"]) == n
    try:
        wait_until(lambda: ready(1), 60, "the first replica ready")
        fleet_zero()
        t0 = time.monotonic()
        for t in threads:
            t.start()
        sizes = [1]
        for want in (2, 3):
            d = auto.tick()
            check(d["action"] == "up", f"the wave did not scale up: {d}")
            wait_until(lambda: ready(want), 60, f"{want} ready replicas")
            sizes.append(want)
        while len(fleet.router.signals()["ready_replicas"]) > 1:
            check(time.monotonic() - t0 < 90, "the fleet never scaled down")
            d = auto.tick()
            if d["action"] == "down":
                wait_until(lambda: d["victim"] not in
                           fleet.router.signals()["ready_replicas"], 30,
                           "the victim gone")
                sizes.append(len(fleet.router.signals()["ready_replicas"]))
        wall = time.monotonic() - t0
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        fleet.stop()
    counts = fleet_counts()
    strip = [{k: v for k, v in d.items()
              if k not in ("enacted", "enact_error")} for d in auto.decisions]
    replay = FleetAutoscaler.replay(auto.signals_log, config=cfg)
    stats = auto.stats.snapshot()
    print(f"(d) a scripted /predict wave: replicas {sizes} over "
          f"{len(auto.decisions)} ticks in {wall:.3f} s, {answered[0]} "
          f"requests, {len(failures)} failed; decisions replay "
          f"bit-exact {strip == replay}; launches {counts}")
    check(not failures, f"a request failed across the scaling: "
          f"{failures[:3]}")
    check(strip == replay, "the decisions did not replay")
    check(stats["scale_ups"] == 2 and stats["scale_downs"] == 2,
          f"the wave did not scale 1 -> 3 -> 1: {stats}")
    check(counts["lstm_scan"] > 0 and counts["lstm_scan_plain"] == 0,
          "K1 was not launched (or the plain scan ran) across the scaling")
    gb = torch.cuda.get_device_properties(dev).total_memory / 2**30
    fps = [model_footprint("bench_lm", lm, hbm_gb=gb),
           model_footprint("char_rnn", net, hbm_gb=gb)]
    plan = pack_models(fps, ["r0"], hbm_gb=gb)
    print(f"(d) pack_models on the card's {gb:.1f} GiB: "
          f"{plan.describe()['assignments']}, utilization "
          f"{plan.describe()['utilization']}, unplaced {plan.unplaced}")
    check(sorted(plan.assignments["r0"]) == ["bench_lm", "char_rnn"]
          and not plan.unplaced, "the card's budget did not place both")
    return {"replicas": sizes, "ticks": len(auto.decisions),
            "requests": answered[0], "failed": len(failures),
            "wall_s": wall, "stats": stats, "launches": counts,
            "placement": plan.describe()}


def online_conf(seed: int):
    return char_rnn_conf(VOCAB, lstm_size=LSTM_H, num_layers=2, seed=seed,
                         tbptt_length=TBPTT, learning_rate=TRAIN_LR)


def fleet_online(net, seed: int, dev, tmp: str) -> dict:
    """(e) ContinuousTrainer rounds; ShadowPromoter mirroring + promote."""
    from deeplearning4j_tpu_torch.online import (
        ContinuousTrainer,
        ShadowPromoter,
    )

    trainee = MultiLayerNetwork(online_conf(seed), device=dev).init(
        input_shape=(1, VOCAB))
    src = StreamSource(watermark=64, idle_s=0.2)
    cand = os.path.join(tmp, "candidate.zip")
    ct = ContinuousTrainer(trainee, src, workers=1, shard=None,
                           handle_signals=False, candidate_path=cand,
                           snapshot_rounds=1, device=dev)
    batches = char_batches(seed + 40, ONLINE_ROUNDS * ONLINE_BATCHES + 1,
                           TRAIN_BATCH)
    fleet_zero()
    t0 = time.perf_counter()
    for r in range(ONLINE_ROUNDS):
        for i in range(ONLINE_BATCHES):
            b = batches[r * ONLINE_BATCHES + i]
            src.push(DataSet(b, batches[r * ONLINE_BATCHES + i + 1]))
        losses = ct.fit_round()
        check(len(losses) == ONLINE_BATCHES and np.isfinite(losses).all(),
              f"round {r + 1} fitted {len(losses)} batches")
    wall = time.perf_counter() - t0
    counts = fleet_counts()
    steps = ct.step
    print(f"(e) ContinuousTrainer: {ct.rounds_done} rounds, {steps} steps "
          f"from a StreamSource in {wall:.3f} s (idle windows included); "
          f"K1 {counts['lstm_scan'] / steps:.1f} and K2 "
          f"{counts['lstm_scan_bwd'] / steps:.1f} a step; candidate "
          f"snapshots {ct.snapshot()['snapshots']}")
    check(ct.rounds_done == ONLINE_ROUNDS and
          counts["lstm_scan"] == 4 * steps and
          counts["lstm_scan_bwd"] == 4 * steps and
          counts["lstm_scan_plain"] == counts["lstm_scan_bwd_plain"] == 0,
          f"the trainer's rounds did not run K1/K2 4 a step: {counts}")
    rows = char_rows(seed + 50, 24)
    eng = ServingEngine(model=net, device=dev).start()
    try:
        off, _ = predict_bodies(eng.url, rows, model="default")
        promoter = ShadowPromoter(eng, min_mirrored=4, fraction=0.5)
        rec = promoter.stage("candidate", model_path=cand,
                             max_batch=eng.max_batch,
                             sample_row=np.zeros((SEQ, VOCAB), np.float32))
        on, _ = predict_bodies(eng.url, rows, model="default")
        check(on == off, "mirroring changed a primary answer")
        check(promoter.mirror.wait_idle(30), "the mirror did not drain")
        mirror = promoter.mirror.report()
        stop, failures, answered = threading.Event(), [], [0]

        def hammer(i):
            while not stop.is_set():
                status, _, body = _call(eng.url, "/predict",
                                        {"batch": rows[i % 24].tolist()})
                if status != 200:
                    failures.append((status, body[:200]))
                answered[0] += 1
                i += 4

        threads = [threading.Thread(target=hammer, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.1)
        report = promoter.promote()
        time.sleep(0.1)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        check(report["ok"] and eng.registry.default().key == rec.key,
              f"the candidate was not promoted: {report}")
        check(not failures, f"a request failed across the swap: "
              f"{failures[:3]}")
    finally:
        eng.stop()
    print(f"(e) ShadowPromoter at fraction 0.5: {mirror['mirrored']} of "
          f"{len(rows)} answered requests mirrored ({mirror['skipped']} "
          f"skipped), the primary's answers byte-equal with mirroring on "
          f"and off; promoted with {answered[0]} requests in flight, none "
          f"failed")
    check(mirror["mirrored"] == len(rows) // 2,
          "the 0.5 stride did not mirror every other request")
    return {"rounds": ct.rounds_done, "steps": steps, "wall_s": wall,
            "launches": counts, "mirror": mirror,
            "promotion_requests": answered[0]}


def elastic_run(seed: int, dev, chaos=None):
    """4 in-process workers, frequency 1, ELASTIC_ROUNDS rounds; the worker
    whose split dies in round 1 (chaos) or w3 (scripted) leaves after
    round 1, and a fresh worker joins before round 3."""
    from deeplearning4j_tpu_torch.parallel.fleet import (
        ElasticParameterAveragingTrainer,
    )

    net = MultiLayerNetwork(online_conf(seed), device=dev).init(
        input_shape=(1, VOCAB))
    xs = char_batches(seed + 60, ELASTIC_ROUNDS + 1, ELASTIC_ROWS)
    tr = ElasticParameterAveragingTrainer(
        net, num_workers=ELASTIC_WORKERS, averaging_frequency=1,
        heartbeat_s=FLEET_HEARTBEAT_S, chaos=chaos, device=dev)
    sizes = []
    t0 = time.perf_counter()
    try:
        for r in range(ELASTIC_ROUNDS):
            if r == 1 and chaos is None:
                tr.evict_worker("w3")
            if r == 2:
                tr.admit_worker()
            tr.fit(xs[r], xs[r + 1])
            sizes.append(len(tr._last_live))
    finally:
        tr.close()
    torch.cuda.synchronize()
    return net, sizes, time.perf_counter() - t0, tr.resilience_stats


def fleet_elastic(seed: int, dev) -> dict:
    """(f) the elastic averaging fleet against the replay of its
    membership sequence."""
    from deeplearning4j_tpu_torch.resilience import (
        FleetChaos,
        FleetChaosConfig,
    )

    fleet_zero()
    net_a, sizes_a, wall_a, stats_a = elastic_run(seed, dev, FleetChaos(
        FleetChaosConfig(kill_split={"round": 1, "split": 3})))
    counts = fleet_counts()
    net_b, sizes_b, wall_b, _ = elastic_run(seed, dev)
    equal = all(torch.equal(a[k], b[k]) for a, b in
                zip(net_a.params, net_b.params) for k in a)
    fits = sum(sizes_a)
    samples = ELASTIC_ROUNDS * ELASTIC_ROWS
    print(f"(f) elastic averaging: workers by round {sizes_a} (a split "
          f"killed in round 1, reclaimed {stats_a['reclaims']} time(s); a "
          f"worker admitted at round 3); params torch.equal to the replay "
          f"of the membership sequence {equal}; K1 "
          f"{counts['lstm_scan'] / fits:.1f} and K2 "
          f"{counts['lstm_scan_bwd'] / fits:.1f} a worker fit; "
          f"{samples / wall_b:.1f} samples/s (the replay; "
          f"{samples / wall_a:.1f} with the reclaim's wait)")
    check(sizes_a == sizes_b == [4, 3, 4, 4],
          f"the membership sequence was {sizes_a} / {sizes_b}")
    check(stats_a["reclaims"] >= 1, "the killed split was not reclaimed")
    check(equal, "the elastic run differs from the replay of its "
          "membership sequence")
    check(counts["lstm_scan"] == 4 * fits and
          counts["lstm_scan_bwd"] == 4 * fits and
          counts["lstm_scan_plain"] == counts["lstm_scan_bwd_plain"] == 0,
          f"K1/K2 were not launched 4 a worker fit: {counts}")
    return {"workers_by_round": sizes_a, "reclaims": stats_a["reclaims"],
            "params_torch_equal_replay": equal, "launches": counts,
            "worker_fits": fits, "samples_per_s": samples / wall_b,
            "samples_per_s_with_reclaim": samples / wall_a}


def fleet_word2vec(seed: int, dev, tmp: str) -> dict:
    """(g) Word2Vec with num_workers=1 on a world-1 NCCL group."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.mesh import device_mesh

    toks = topic_corpus(seed)[:FLEET_W2V_SENTENCES]
    kw = dict(layer_size=W2V_D, window=W2V_WINDOW, negative=W2V_NEG,
              batch_size=W2V_BATCH, min_word_frequency=W2V_MIN_COUNT,
              seed=seed, device=dev)

    def fits(group):
        plain = Word2Vec(**kw).fit_tokens(toks)
        fleet_zero()
        dp = Word2Vec(num_workers=1, mesh=group, **kw).fit_tokens(toks)
        return plain, dp, fleet_counts()

    init_seq_group(os.path.join(tmp, "w2v_store"), 0, 1, backend="nccl")
    try:
        group = device_mesh((1,), ("data",)).group("data")
        mode = "deterministic algorithms"
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    plain, dp, counts = fits(group)
                finally:
                    torch.use_deterministic_algorithms(False)
        except RuntimeError as e:
            mode = f"default algorithms ({type(e).__name__} under " \
                   f"deterministic ones)"
            plain, dp, counts = fits(group)
    finally:
        dist.destroy_process_group()
    names = ("syn0", "syn1", "syn1neg")
    equal = all(np.array_equal(getattr(plain.lookup_table, n),
                               getattr(dp.lookup_table, n)) for n in names)
    nb = dp.fit_stats["batches"]
    print(f"(g) Word2Vec(num_workers=1) on a world-1 NCCL group, "
          f"{len(toks)} sentences, {nb} batches under {mode}: tables "
          f"torch.equal to the plain fit {equal}; K3 {counts['sgns_step']} "
          f"launches, plain {counts['sgns_step_plain']}")
    check(dp.mesh is group, "the fit did not take the NCCL group")
    check(counts["sgns_step"] == nb and counts["sgns_step_plain"] == 0,
          "K3 was not launched once a batch")
    check(equal, "the data-parallel fit differs from the plain fit")
    return {"batches": nb, "launches": counts, "torch_equal": equal,
            "mode": mode}


def phase_fleet(cfg: TransformerConfig, net: MultiLayerNetwork, burst_reqs,
                seed: int, dev):
    """The serving fleet, autoscaling and placement, the sharded tick,
    shadow promotion with the ContinuousTrainer, the elastic averaging
    fleet and data-parallel Word2Vec (module docstring, 21)."""
    print("== the serving fleet, the online plane and the elastic fleet ==")
    t0 = time.perf_counter()
    # the serve phase's 16 requests and its streamed one (through the
    # router's streaming pass-through)
    burst_reqs = list(burst_reqs) + [dict(burst_reqs[1], stream=True)]
    lm = TransformerLM(cfg, device=dev)
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        threads, toks_solo, seq_solo, rows, nb = fleet_threads(
            lm, net, burst_reqs, seed, dev)
        procs = fleet_processes(net, rows, seq_solo, tmp)
        disagg = fleet_disaggregated(lm, burst_reqs, toks_solo, nb, seed,
                                     dev)
        scale = fleet_autoscale(lm, net, seed, dev)
        del lm
        torch.cuda.empty_cache()
        online = fleet_online(net, seed, dev, tmp)
        elastic = fleet_elastic(seed, dev)
        w2v = fleet_word2vec(seed, dev, tmp)
    for part in (threads["generate"]["launches"],
                 threads["predict"]["launches"], disagg["launches"],
                 scale["launches"], online["launches"], elastic["launches"],
                 w2v["launches"]):
        for k, v in part.items():
            counts[k] = counts.get(k, 0) + v
    wall = time.perf_counter() - t0
    print(f"fleet phase: {wall:.1f} s; launches {counts}")
    return counts, {"threads": threads, "processes": procs,
                    "disaggregation": disagg, "autoscale": scale,
                    "online": online, "elastic": elastic, "word2vec": w2v,
                    "wall_s": wall}


# ---------------------------------------------------------------------------
# the NLP, graph and t-SNE models: ParagraphVectors (DBOW, DM), GloVe,
# DeepWalk, exact t-SNE; generate on a Megatron group
# ---------------------------------------------------------------------------

# ParagraphVectors at the word2vec phase's widths on its corpus, each
# sentence labelled TOPIC_<t> by its topic; 200 held-out sentences of the
# same topics from default_rng(seed + 7)
PV_HELD_OUT, PV_INFER_STEPS = 200, 10
# top-1 nearest_labels agreement of the held-out sentences with their topic
# after the same DBOW fit on the CPU (device="cpu", seed 0, the CPU
# generator's negatives), from chip_smoke.embeddings_rehearsal: 5,857,208
# co-training pairs in 2,860 batches, 1,000,000 DBOW pairs in 489
PV_AGREEMENT_CPU = 1.0
DM_SENTENCES = 2000
# GloVe on the first 2,000 sentences (200 k tokens) at its DL4J window
GLOVE_SENTENCES, GLOVE_D, GLOVE_WINDOW, GLOVE_BATCH, GLOVE_EPOCHS = \
    2000, 128, 15, 4096, 5
# DeepWalk on a stochastic block model: 100 communities of 100 vertices,
# ~16 neighbours inside a vertex's community and ~2 outside
SBM_COMMUNITIES, SBM_SIZE, SBM_DEG_IN, SBM_DEG_OUT = 100, 100, 16, 2
DW_D, DW_WALK, DW_WINDOW, DW_QUERIES, DW_TOP = 128, 40, 5, 500, 10
# the share of the top-10 vertices_nearest in the vertex's own community
# after the same fit on the CPU, from chip_smoke.embeddings_rehearsal:
# 89,822 edges, 3,800,000 pairs in 1,856 batches
DW_COMMUNITY_CPU = 0.9588
# exact t-SNE of the word2vec fit's 5,000 most frequent words' vectors
TSNE_N, TSNE_ITERS = 5000, 1000
TSNE_PASSES = 24  # N x N f32 reads and writes of tsne_step (no KL), counted
TOL_EMB = 1e-5  # the card's step against the CPU's: of each output's largest
GEN_NEW = 16
EMB_COUNTERS = (sgns_step, sgns_step_plain, flash_attention,
                flash_attention_plain)


def emb_counts():
    return {fn.__name__: fn.launches for fn in EMB_COUNTERS}


def emb_zero():
    for fn in EMB_COUNTERS:
        fn.launches = 0


def sentence_topics(corpus) -> np.ndarray:
    """Each sentence's topic: the one most of its words belong to."""
    return np.array([np.bincount([int(w[1:]) % W2V_TOPICS for w in s],
                                 minlength=W2V_TOPICS).argmax()
                     for s in corpus])


def held_out_sentences(seed: int, n: int = PV_HELD_OUT):
    """(sentences, topics): sentence i of topic i % W2V_TOPICS, W2V_SENT
    words from the topic's Zipf distribution, or with probability
    W2V_NOISE from a Zipf distribution over all words."""
    rng = np.random.default_rng(seed + 7)
    zipf = lambda m, k: np.minimum(np.searchsorted(
        np.cumsum(1.0 / np.arange(1, m + 1)) / np.sum(
            1.0 / np.arange(1, m + 1)), rng.random(k)), m - 1)
    glob_word = rng.permutation(W2V_VOCAB)
    out, topics = [], []
    for i in range(n):
        t = i % W2V_TOPICS
        members = np.arange(t, W2V_VOCAB, W2V_TOPICS)
        words = np.where(rng.random(W2V_SENT) < W2V_NOISE,
                         glob_word[zipf(W2V_VOCAB, W2V_SENT)],
                         members[zipf(len(members), W2V_SENT)])
        out.append(" ".join(f"w{w}" for w in words))
        topics.append(t)
    return out, np.array(topics)


def pv_model(seed: int, dev, dm: bool = False):
    from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (
        ParagraphVectors,
    )

    return ParagraphVectors(dm=dm, layer_size=W2V_D, window=W2V_WINDOW,
                            negative=W2V_NEG, batch_size=W2V_BATCH, epochs=1,
                            min_word_frequency=W2V_MIN_COUNT, seed=seed,
                            device=dev)


def emb_paragraph_vectors(corpus, seed: int, dev, dm: bool = False) -> dict:
    """One ParagraphVectors fit (DBOW, or DM) on ``corpus``: the word
    co-training's and the document loop's pairs/s, K3 launches against
    the co-training's batches; for DBOW the held-out topic agreement and
    infer_vector's ms."""
    from deeplearning4j_tpu_torch.nlp.text import LabelledDocument

    topics = sentence_topics(corpus)
    docs = [LabelledDocument(" ".join(s), [f"TOPIC_{t}"])
            for s, t in zip(corpus, topics)]
    model = pv_model(seed, dev, dm)
    emb_zero()
    t0 = time.perf_counter()
    model.fit_documents(docs)
    fit_s = time.perf_counter() - t0
    counts = emb_counts()
    words, dst = model.fit_stats["words"], model.fit_stats["docs"]
    rep = {"fit_s": fit_s, "launches": counts, "words": words, "docs": dst,
           "cotrain_pairs_per_s": words["examples"] / words["loop_s"],
           "doc_pairs_per_s": dst["examples"] / dst["loop_s"]}
    name = "DM" if dm else "DBOW"
    print(f"ParagraphVectors {name} on {len(docs)} sentences: vocabulary "
          f"{model.vocab_size()}, {len(model.labels)} labels; word "
          f"co-training {words['examples']} pairs in {words['batches']} "
          f"batches, {rep['cotrain_pairs_per_s']:.0f} pairs/s (loop "
          f"{words['loop_s']:.3f} s, assembly {words['assembly_s']:.3f} s); "
          f"{name} {dst['examples']} examples in {dst['batches']} batches, "
          f"{rep['doc_pairs_per_s']:.0f} examples/s (loop {dst['loop_s']:.3f}"
          f" s, assembly {dst['assembly_s']:.3f} s); fit {fit_s:.2f} s; "
          f"launches {counts}")
    check(np.isfinite(model.doc_vectors).all(),
          f"{name}: a document vector is not finite")
    if dev.type == "cuda":  # on the CPU the plain versions count
        check(counts["sgns_step"] == words["batches"]
              and counts["sgns_step_plain"] == 0,
              f"{name}: K3 did not run exactly once per co-training batch")
    if dm:
        return rep
    texts, want = held_out_sentences(seed)
    t0 = time.perf_counter()
    vecs = [model.infer_vector(t, PV_INFER_STEPS) for t in texts]
    rep["infer_ms"] = (time.perf_counter() - t0) * 1e3 / len(texts)
    got = [model.nearest_labels(v, 1)[0] for v in vecs]
    rep["agreement"] = float(np.mean([g == f"TOPIC_{t}"
                                      for g, t in zip(got, want)]))
    print(f"infer_vector ({PV_INFER_STEPS} steps, {model._INFER_PAD} words): "
          f"{rep['infer_ms']:.3f} ms a sentence; top-1 nearest_labels "
          f"agreement with the topic on {len(texts)} held-out sentences: "
          f"{rep['agreement']:.4f} (chance {1 / W2V_TOPICS:.4f}, CPU "
          f"rehearsal {PV_AGREEMENT_CPU})")
    rep["model"] = model
    return rep


def sbm_graph(seed: int):
    """(graph, community of each vertex): SBM_COMMUNITIES communities of
    SBM_SIZE vertices; each pair inside a community an edge with
    probability SBM_DEG_IN / (SBM_SIZE - 1), and n * SBM_DEG_OUT / 2
    edges between uniform pairs of different communities."""
    from deeplearning4j_tpu_torch.graph import Graph

    rng = np.random.default_rng(seed + 11)
    n = SBM_COMMUNITIES * SBM_SIZE
    comm = np.arange(n) // SBM_SIZE
    g = Graph(n)
    a, b = np.triu_indices(SBM_SIZE, 1)
    for c in range(SBM_COMMUNITIES):
        keep = rng.random(len(a)) < SBM_DEG_IN / (SBM_SIZE - 1)
        for u, v in zip(a[keep] + c * SBM_SIZE, b[keep] + c * SBM_SIZE):
            g.add_edge(int(u), int(v))
    m = n * SBM_DEG_OUT // 2
    u, v = rng.integers(0, n, m), rng.integers(0, n, m)
    for x, y in zip(u[comm[u] != comm[v]], v[comm[u] != comm[v]]):
        g.add_edge(int(x), int(y))
    return g, comm


def emb_deepwalk(seed: int, dev) -> dict:
    from deeplearning4j_tpu_torch.graph import DeepWalk, RandomWalkIterator

    t0 = time.perf_counter()
    g, comm = sbm_graph(seed)
    graph_s = time.perf_counter() - t0
    dw = DeepWalk(vector_size=DW_D, window_size=DW_WINDOW, seed=seed,
                  device=dev).initialize(g)
    t0 = time.perf_counter()
    walks = list(RandomWalkIterator(g, DW_WALK, seed=seed))
    walk_s = time.perf_counter() - t0
    dw.fit_walks(walks)
    st = dw.fit_stats
    queries = np.arange(0, g.num_vertices(), g.num_vertices() // DW_QUERIES)
    share = float(np.mean([comm[dw.vertices_nearest(int(q), DW_TOP)]
                           == comm[q] for q in queries]))
    deg = g.degrees()
    rep = {"vertices": g.num_vertices(), "edges": int(deg.sum()) // 2,
           "graph_s": graph_s, "walk_s": walk_s, "pairs": st["pairs"],
           "batches": st["batches"], "pairs_s": st["pairs_s"],
           "loop_s": st["loop_s"], "pairs_per_s": st["pairs"] / st["loop_s"],
           "community_share": share}
    print(f"DeepWalk on an SBM of {rep['vertices']} vertices, {rep['edges']}"
          f" edges (mean degree {deg.mean():.2f}; graph {graph_s:.2f} s): "
          f"walks {walk_s:.2f} s, pairs {st['pairs_s']:.2f} s (host); "
          f"{st['pairs']} pairs in {st['batches']} batches, "
          f"{rep['pairs_per_s']:.0f} pairs/s (loop {st['loop_s']:.3f} s); "
          f"top-{DW_TOP} vertices_nearest in the own community over "
          f"{len(queries)} vertices: {share:.4f} (chance "
          f"{(SBM_SIZE - 1) / (g.num_vertices() - 1):.4f}, CPU rehearsal "
          f"{DW_COMMUNITY_CPU})")
    check(np.isfinite(dw.vertex_vectors).all(),
          "DeepWalk: a vertex vector is not finite")
    return rep


def emb_glove(corpus, seed: int, dev) -> dict:
    from deeplearning4j_tpu_torch.nlp.glove import Glove

    glove = Glove(layer_size=GLOVE_D, window=GLOVE_WINDOW,
                  batch_size=GLOVE_BATCH, epochs=GLOVE_EPOCHS, seed=seed,
                  device=dev)
    t0 = time.perf_counter()
    glove.fit([" ".join(s) for s in corpus])
    fit_s = time.perf_counter() - t0
    st = glove.fit_stats
    rep = dict(st, fit_s=fit_s, losses=glove.losses,
               pairs_per_s=st["pairs"] * GLOVE_EPOCHS / st["loop_s"])
    print(f"GloVe on {len(corpus)} sentences: vocabulary "
          f"{glove.vocab.num_words()}, {st['pairs']} co-occurrence pairs "
          f"(count {st['count_s']:.3f} s, host); {st['batches']} batches of "
          f"{GLOVE_BATCH} over {GLOVE_EPOCHS} epochs, {rep['pairs_per_s']:.0f}"
          f" pairs/s (loop {st['loop_s']:.3f} s); fit {fit_s:.2f} s; loss "
          f"by epoch {[round(x, 6) for x in glove.losses]}")
    check(np.isfinite(glove.W).all(), "GloVe: W is not finite")
    check(all(b < a for a, b in zip(glove.losses, glove.losses[1:])),
          "GloVe: the loss did not fall every epoch")
    return rep


def emb_tsne(w2v, seed: int, dev):
    """Exact t-SNE of the TSNE_N most frequent words' vectors; returns the
    report and P (on the card) for the step checks."""
    from deeplearning4j_tpu_torch.plot import tsne as tsne_mod

    x = np.asarray(w2v.lookup_table.syn0[:TSNE_N], np.float64)
    ts = tsne_mod.Tsne(max_iter=TSNE_ITERS, seed=seed, device=dev)
    spans, last = {}, {}
    input_p = ts._input_p

    def timed_input_p(a):
        t0 = time.perf_counter()
        out = input_p(a)
        spans["input_p_s"] = time.perf_counter() - t0
        return out

    step = tsne_mod.tsne_step

    def recorded_step(P, Y, vel, gains, momentum, lr, kl=False):
        last.update(P=P, Y=Y, vel=vel, gains=gains)
        return step(P, Y, vel, gains, momentum, lr, kl)

    ts._input_p = timed_input_p
    tsne_mod.tsne_step = recorded_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    try:
        t0 = time.perf_counter()
        y = ts.fit_transform(x)
        fit_s = time.perf_counter() - t0
    finally:
        tsne_mod.tsne_step = step
    peak = torch.cuda.max_memory_allocated() - held
    P = last["P"]
    ys = [last[k].clone() for k in ("Y", "vel", "gains")]
    step_ms = device_ms(lambda: step(P, *[a.clone() for a in ys], 0.8,
                                     200.0), iters=10)
    n = P.shape[0]
    bound_ms, bound_by = bound(n * n * 4.0, 20.0 * n * n, PEAK_F32_FLOPS)
    code_ms = TSNE_PASSES * n * n * 4.0 / PEAK_BYTES_PER_S * 1e3
    kl = ts.kl_history
    rep = {"n": n, "dim": x.shape[1], "iters": TSNE_ITERS,
           "input_p_s": spans["input_p_s"], "fit_s": fit_s,
           "loop_ms_per_step": (fit_s - spans["input_p_s"]) * 1e3
           / TSNE_ITERS, "step_ms": step_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "code_traffic_ms": code_ms,
           "kl_first": kl[0], "kl_last": kl[-1], "kl_history": kl,
           "peak_memory_bytes": peak}
    print(f"exact t-SNE of the {n} most frequent words' {x.shape[1]}-wide "
          f"vectors, {TSNE_ITERS} iterations: _input_p "
          f"{spans['input_p_s']:.2f} s (host, f64); fit {fit_s:.2f} s, "
          f"{rep['loop_ms_per_step']:.3f} ms a step of host wall; "
          f"tsne_step {step_ms:.4f} ms (device time) against a bound of "
          f"{bound_ms:.4f} ms ({bound_by}: one read of P) and "
          f"{code_ms:.4f} ms for the code's {TSNE_PASSES} N x N f32 passes; "
          f"KL {kl[0]:.4f} -> {kl[-1]:.4f}; device memory at its peak "
          f"{peak / 2**20:.1f} MiB above the earlier phases'")
    check(np.isfinite(y).all(), "t-SNE: Y is not finite")
    # kl[0], kl[1] are of the exaggerated P (iterations 0 and 50 < 100)
    check(kl[-1] < kl[min(2, len(kl) - 1)],
          "t-SNE: the KL divergence did not fall after the exaggeration")
    return rep, P


EMB_STEPS = ("dbow_step", "dm_step", "infer_dbow_step", "glove_step",
             "hs_body", "tsne_step")


def emb_step_inputs(seed: int, P, v: int = W2V_VOCAB, b: int = W2V_BATCH,
                    d: int = W2V_D) -> dict:
    """Seeded f32 host inputs of the device steps: tables [v, d], a batch
    of b rows (repeated rows, dead path entries, 7 padded pairs), paths
    of 18, context windows of 2 x W2V_WINDOW; for tsne_step the
    affinities ``P`` [N, N] and the fit's first Y ~ N(0, 1e-4). Not a
    late Y: there some gradient entries are ~0, and the gains rule keys
    on their signs, which two summation orders may flip."""
    rng = np.random.default_rng(seed + 13)
    l, nd, c = 18, W2V_TOPICS, 2 * W2V_WINDOW
    f = lambda *sh: (rng.standard_normal(sh) * 0.1).astype(np.float32)
    return {"syn0": f(v, d), "syn1": f(v, d), "docvecs": f(nd, d),
            "doc_ids": rng.integers(0, nd, b), "cx": rng.integers(0, v, b),
            "wj": rng.integers(0, v, b),
            "points": rng.integers(0, v - 1, (b, l)),
            "codes": rng.integers(0, 2, (b, l)).astype(np.float32),
            "mask": (rng.random((b, l)) < 0.8).astype(np.float32),
            "ctx": rng.integers(0, v, (b, c)),
            "cmask": (rng.random((b, c)) < 0.7).astype(np.float32),
            "hW": np.abs(f(v, d)) + 1e-8, "hb": np.abs(f(v)) + 1e-8,
            "bias": f(v),
            "logx": np.log(rng.random(b) * 20 + 1).astype(np.float32),
            "fdiff": rng.random(b).astype(np.float32),
            "live": (np.arange(b) < b - 7).astype(np.float32),
            "P": np.asarray(P, np.float32),
            "Y": np.random.default_rng(seed).normal(
                0, 1e-4, (len(P), 2)).astype(np.float32)}


def emb_run_step(name: str, inp: dict, dev) -> dict:
    """One step of the device function ``name`` on ``dev`` from copies of
    ``emb_step_inputs``; its outputs by name, on the host."""
    from deeplearning4j_tpu_torch.graph.deepwalk import hs_body
    from deeplearning4j_tpu_torch.nlp.glove import glove_step
    from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (
        dbow_step,
        dm_step,
        infer_dbow_step,
    )
    from deeplearning4j_tpu_torch.plot.tsne import tsne_step

    t = {k: torch.tensor(a, device=dev) for k, a in inp.items()}
    if name == "dbow_step":
        dbow_step(t["docvecs"], t["syn1"], t["doc_ids"], t["points"],
                  t["codes"], t["mask"], 0.025)
        keys = ("docvecs", "syn1")
    elif name == "dm_step":
        dm_step(t["syn0"], t["syn1"], t["docvecs"], t["doc_ids"], t["ctx"],
                t["cmask"], t["points"], t["codes"], t["mask"], 0.025)
        keys = ("syn0", "syn1", "docvecs")
    elif name == "infer_dbow_step":
        t["vec"] = t["docvecs"][:1].clone()
        infer_dbow_step(t["vec"], t["syn1"], t["points"][:64],
                        t["codes"][:64], t["mask"][:64], 0.025)
        keys = ("vec", "syn1")
    elif name == "glove_step":
        t["loss"] = glove_step(t["syn0"], t["bias"], t["hW"], t["hb"],
                               t["cx"], t["wj"], t["logx"], t["fdiff"], 0.05,
                               t["live"])
        keys = ("syn0", "bias", "hW", "hb", "loss")
    elif name == "hs_body":
        hs_body(t["syn0"], t["syn1"], t["cx"], t["points"], t["codes"],
                t["mask"] * t["live"][:, None], 0.025)
        keys = ("syn0", "syn1")
    else:
        t["vel"], t["gains"] = torch.zeros_like(t["Y"]), torch.ones_like(
            t["Y"])
        t["kl"] = tsne_step(t["P"], t["Y"], t["vel"], t["gains"], 0.5, 200.0,
                            kl=True)
        keys = ("Y", "vel", "gains", "kl")
    return {k: t[k].cpu().numpy() for k in keys}


def emb_step_errors(name: str, inp: dict, dev) -> dict:
    """max |card - CPU| / max |CPU| of each output of one step."""
    card, cpu = emb_run_step(name, inp, dev), emb_run_step(
        name, inp, torch.device("cpu"))
    return {k: float(np.abs(card[k] - cpu[k]).max()
                     / max(np.abs(cpu[k]).max(), 1e-30)) for k in cpu}


def emb_step_checks(seed: int, dev, P) -> dict:
    """One step of each device function on the card and on the CPU from
    the same seeded f32 inputs: the embedding steps at (a)'s widths,
    tsne_step on (e)'s P."""
    inp = emb_step_inputs(seed, P.cpu().numpy())
    errs = {name: emb_step_errors(name, inp, dev) for name in EMB_STEPS}
    print("one step of each device function, card against CPU (max err / "
          f"largest entry, tol {TOL_EMB}): "
          + "; ".join(f"{n} " + ", ".join(f"{k} {e:.2e}"
                                          for k, e in es.items())
                      for n, es in errs.items()))
    worst = max(e for es in errs.values() for e in es.values())
    check(worst <= TOL_EMB, "a device step on the card disagrees with the "
          "same step on the CPU")
    return errs


def emb_generate(cfg: TransformerConfig, seed: int, dev) -> dict:
    """``generate`` of the bench transformer in the Megatron mode on a
    world-1 NCCL group against the same model with no group: the cached
    sampler both ways, and the group's default (the full-forward sampler)
    against the full-forward sampler with no group."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.mesh import device_mesh

    prompt = np.random.default_rng(seed + 17).integers(
        0, cfg.vocab_size, (2, 64))
    kw = dict(temperature=1e-8, seed=seed)
    emb_zero()
    with tempfile.TemporaryDirectory() as tmp:
        init_seq_group(os.path.join(tmp, "gen_store"), 0, 1, backend="nccl")
        try:
            lm = TransformerLM(cfg, device=dev)
            mesh_lm = TransformerLM(cfg, device=dev, params=lm.params,
                                    group=device_mesh((1, 1),
                                                      ("data", "model")))
            check(mesh_lm.mode == "megatron", "the group LM is not Megatron")
            t0 = time.perf_counter()
            got = {"cache": mesh_lm.generate(prompt, GEN_NEW, use_cache=True,
                                             **kw),
                   "default": mesh_lm.generate(prompt, GEN_NEW, **kw)}
            mesh_s = time.perf_counter() - t0
            want = {"cache": lm.generate(prompt, GEN_NEW, use_cache=True,
                                         **kw),
                    "default": lm.generate(prompt, GEN_NEW, use_cache=False,
                                           **kw)}
        finally:
            dist.destroy_process_group()
    del lm, mesh_lm
    torch.cuda.empty_cache()
    same = {k: bool(torch.equal(got[k], want[k])) for k in got}
    counts = emb_counts()
    print(f"generate in the Megatron mode on a world-1 NCCL group, {GEN_NEW} "
          f"greedy tokens after 2 x 64: torch.equal to the model with no "
          f"group {same} ({mesh_s:.2f} s for both samplers on the group); "
          f"launches {counts}")
    check(all(same.values()), "generate on a Megatron group differs from "
          "the same model with no group")
    check(counts["flash_attention"] > 0
          and counts["flash_attention_plain"] == 0,
          "generate's prefill did not run through K4")
    return {"equal": same, "wall_s": mesh_s, "launches": counts}


def phase_embeddings(seed: int, dev, w2v: Word2Vec, cfg: TransformerConfig):
    """ParagraphVectors (DBOW, DM), GloVe, DeepWalk and exact t-SNE on the
    card, one step of each device function against the CPU, and generate
    on a Megatron group (module docstring)."""
    print("== the NLP, graph and t-SNE models ==")
    t_phase = time.perf_counter()
    corpus = topic_corpus(seed)
    dbow = emb_paragraph_vectors(corpus, seed, dev)
    pv = dbow.pop("model")
    check(dbow["agreement"] >= 10.0 / W2V_TOPICS,
          "ParagraphVectors: the held-out agreement is not 10x chance")
    check(dbow["agreement"] >= PV_AGREEMENT_CPU - 0.05,
          "ParagraphVectors: the held-out agreement fell more than 0.05 "
          "below the CPU rehearsal's")
    k3 = dbow["launches"]["sgns_step"]
    del pv
    dm = emb_paragraph_vectors(corpus[:DM_SENTENCES], seed, dev, dm=True)
    k3 += dm["launches"]["sgns_step"]
    glove = emb_glove(corpus[:GLOVE_SENTENCES], seed, dev)
    dw = emb_deepwalk(seed, dev)
    check(dw["community_share"] >= 0.5,
          "DeepWalk: less than half the nearest vertices share a community")
    check(dw["community_share"] >= DW_COMMUNITY_CPU - 0.05,
          "DeepWalk: the community share fell more than 0.05 below the CPU "
          "rehearsal's")
    tsne, P = emb_tsne(w2v, seed, dev)
    steps = emb_step_checks(seed, dev, P)
    del P
    torch.cuda.empty_cache()
    gen = emb_generate(cfg, seed, dev)
    wall = time.perf_counter() - t_phase
    print(f"NLP, graph and t-SNE phase: {wall:.1f} s")
    return ({"sgns_step": k3, "flash_attention":
             gen["launches"]["flash_attention"]},
            {"paragraph_vectors_dbow": dbow, "paragraph_vectors_dm": dm,
             "glove": glove, "deepwalk": dw, "tsne": tsne,
             "step_errors": steps, "generate": gen, "wall_s": wall})


def embeddings_rehearsal(seed: int = 0):
    """(a) and (d) of the embeddings phase on the CPU: the sources of
    PV_AGREEMENT_CPU and DW_COMMUNITY_CPU. Run as ``python3 -c "import
    chip_smoke; chip_smoke.embeddings_rehearsal()"``."""
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    dbow = emb_paragraph_vectors(topic_corpus(seed), seed, cpu)
    dw = emb_deepwalk(seed, cpu)
    print(f"CPU rehearsal, seed {seed}, {time.perf_counter() - t0:.1f} s: "
          f"ParagraphVectors agreement {dbow['agreement']!r}; DeepWalk "
          f"community share {dw['community_share']!r}")
    return dbow["agreement"], dw["community_share"]


# ---------------------------------------------------------------------------
# the tooling entry points: the north-star harness, the CLI, the training
# UI and its listeners, torch.profiler traces, and the host text tools
# ---------------------------------------------------------------------------

NS_STEPS = 100               # the north star's steps (BASELINE.json:5)
TOL_NORTH_STAR = 1e-3        # max relative deviation, card against CPU
# ...unless the CPU curve moves further from itself when its start moves
# one ulp: RMSProp at lr 0.1 turns a 1e-7 change of the char-RNN's start
# into 5-6 % of its loss within 5 steps on the CPU alone, and LeNet-5's
# Nesterovs into 2e-3 by step 69 (this phase prints both). Then the bar
# is NS_CHAOS_FACTOR times the largest of NS_CHAOS_RUNS such spreads.
NS_CHAOS_RUNS, NS_CHAOS_FACTOR = 3, 2.0
TOL_NS_FIRST = 1e-5          # the first step: a forward, no update yet
CLI_BATCHES = 8              # the CLI's char-RNN npz: 8 batches of 32
UI_FITS, UI_LENET_FITS = 8, 4
UI_EVERY = 2                 # the UI listeners' frequency
UI_TSNE_WORDS, UI_NN_WORDS, UI_NN_QUERIES, UI_NN_K = 1000, 5000, 100, 10
K1_NAME, K2_NAMES = "lstm_fwd_cluster", ("lstm_bwd_gates", "lstm_bwd_sweep",
                                         "lstm_bwd_du", "lstm_bwd_finish")
TFIDF_TOPICS, TFIDF_HIDDEN, TFIDF_BATCH = 10, 64, 100
TOL_TFIDF = 1e-3             # the TF-IDF MLP's losses, card against CPU
PARSE_SENTENCES = 200
INDEX_WORD_RANKS = (0, 1, 2, 5, 10, 100, 1000, 10_000, 50_000, 71_289)


def lstm_counts() -> dict:
    return {fn.__name__: fn.launches for fn in RT_COUNTERS}


def lstm_since(before: dict) -> dict:
    now = lstm_counts()
    return {k: now[k] - before[k] for k in now}


def full_char_rnn(seed: int, dev) -> MultiLayerNetwork:
    """``phase_train``'s full-width char-RNN."""
    conf = char_rnn_conf(VOCAB, lstm_size=LSTM_H, num_layers=2, seed=seed,
                         tbptt_length=TBPTT, learning_rate=TRAIN_LR)
    return MultiLayerNetwork(conf, device=dev).init(input_shape=(1, VOCAB))


def char_ids(seed: int, rows: int, cols: int) -> np.ndarray:
    """[rows, cols] character ids of one-step Markov text over VOCAB."""
    chars = [chr(32 + i) for i in range(VOCAB)]
    text = markov_text(seed, rows * cols, chars)
    return (np.frombuffer(text.encode("ascii"), np.uint8).astype(np.int64)
            - 32).reshape(rows, cols)


def one_ulp_start(builder, seed: int):
    """``builder`` with every parameter of its fresh net moved one ulp up
    or down (a seeded coin per entry): the smallest change of the start
    an f32 implementation can make."""
    def build(device):
        net = builder(device)
        gen = torch.Generator().manual_seed(seed)

        def kick(t):
            up = torch.rand(t.shape, generator=gen) < 0.5
            inf = torch.full_like(t, float("inf"))
            return torch.nextafter(t, torch.where(up, inf, -inf))

        net.params = lowprec.tree_map(kick, net.params)
        return net

    return build


def first_past(rel: np.ndarray, bar: float):
    over = np.flatnonzero(rel > bar)
    return int(over[0]) if over.size else None


def tool_north_star(dev) -> dict:
    """(a): ``run_north_star`` on the card; K1/K2 counted over the card's
    char-RNN leg alone (its builder snapshots the counters). Each curve's
    bar is TOL_NORTH_STAR or NS_CHAOS_FACTOR times the CPU's own spread
    under a one-ulp change of the start (NS_CHAOS_RUNS runs), whichever
    is larger; the first step, a forward with no update yet, is held to
    TOL_NS_FIRST."""
    from deeplearning4j_tpu_torch.utils import equivalence as eq

    marks = []
    build = eq.char_builder

    def char_builder(device):
        if torch.device(device).type == "cuda":
            marks.append(lstm_counts())
        return build(device)

    t0 = time.perf_counter()
    eq.char_builder = char_builder
    try:
        res = eq.run_north_star(steps=NS_STEPS, device=dev)
    finally:
        eq.char_builder = build
    wall = time.perf_counter() - t0
    card_leg = lstm_since(marks[0]) if dev.type == "cuda" else None
    legs = {"lenet5": (eq.lenet_builder, eq.mnist_batches(NS_STEPS)),
            "char_rnn": (eq.char_builder, eq.char_batches(NS_STEPS))}
    t0 = time.perf_counter()
    for name, r in res.items():
        builder, batches = legs[name]
        cpu = np.asarray(r["curve_cpu"])
        spread = []
        for k in range(1, NS_CHAOS_RUNS + 1):
            c = eq.loss_curve(one_ulp_start(builder, k), batches,
                              device="cpu")
            rel = np.abs(c - cpu) / np.abs(cpu)
            spread.append({"max_rel_deviation": float(rel.max()),
                           "first_step_over_1e-3": first_past(rel, 1e-3)})
        rel_card = np.abs(np.asarray(r["curve_accel"]) - cpu) / np.abs(cpu)
        r["cpu_one_ulp_spread"] = spread
        r["bar"] = max(TOL_NORTH_STAR, NS_CHAOS_FACTOR * max(
            x["max_rel_deviation"] for x in spread))
        r["first_step_rel_deviation"] = float(rel_card[0])
        print(f"north star {name}: {r['steps']} steps on "
              f"{r['backend_cpu']} and {r['device_name']}; final loss "
              f"{r['final_loss_cpu']!r} (CPU) and {r['final_loss_accel']!r} "
              f"(card); max abs deviation {r['max_abs_deviation']!r}, max "
              f"relative deviation {r['max_rel_deviation']!r}, first step "
              f"past 1e-3 {r['first_step_over_1e-3']}; the CPU against "
              f"itself from a start one ulp away: "
              f"{[(x['max_rel_deviation'], x['first_step_over_1e-3']) for x in spread]}"
              f" (max relative deviation, first step past 1e-3); bar "
              f"{r['bar']!r}; the first step (no update yet) "
              f"{r['first_step_rel_deviation']!r} (bar {TOL_NS_FIRST})")
        print(f"  relative deviation, steps 0-9: "
              f"{[float(f'{v:.3e}') for v in rel_card[:10]]}")
        check(np.isfinite(r["curve_cpu"]).all()
              and np.isfinite(r["curve_accel"]).all(),
              f"north star {name}: a loss is not finite")
        check(r["first_step_rel_deviation"] <= TOL_NS_FIRST,
              f"north star {name}: the first step's loss is "
              f"{r['first_step_rel_deviation']!r} off the CPU's")
        check(r["max_rel_deviation"] <= r["bar"],
              f"north star {name}: the curves part at step "
              f"{r['first_step_over_1e-3']} (max relative deviation "
              f"{r['max_rel_deviation']!r} > {r['bar']!r})")
    spread_s = time.perf_counter() - t0
    print(f"north star: both models, both legs, {wall:.1f} s; the one-ulp "
          f"CPU runs {spread_s:.1f} s; K1/K2 over the card's char-RNN leg: "
          f"{card_leg}")
    if dev.type == "cuda":
        want = NS_STEPS * 2  # 2 TBPTT windows of 16 a step, one layer
        check(card_leg["lstm_scan"] == card_leg["lstm_scan_bwd"] == want,
              f"north star: K1/K2 did not launch {want} times on the card")
        check(card_leg["lstm_scan_plain"] == 0
              and card_leg["lstm_scan_bwd_plain"] == 0,
              "north star: a plain LSTM scan ran in the card's leg")
    return {"results": res, "wall_s": wall, "spread_s": spread_s,
            "launches": card_leg}


def tool_cli(seed: int, dev, tmp: str) -> dict:
    """(b): ``main(["train", ...])`` on the full-width char-RNN; train,
    test and predict on an iris CSV; the same predict as a subprocess."""
    import contextlib
    import io
    import re

    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.datasets.fetchers import load_iris

    def run(argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(rc == 0, f"cli {argv[0]} returned {rc}")
        return buf.getvalue(), wall

    conf_path = os.path.join(tmp, "char_rnn.json")
    with open(conf_path, "w") as f:
        f.write(full_char_rnn(seed, "cpu").conf.to_json())
    ids = char_ids(seed + 11, CLI_BATCHES * TRAIN_BATCH, SEQ + 1)
    eye = np.eye(VOCAB, dtype=np.float32)
    npz = os.path.join(tmp, "chars.npz")
    np.savez(npz, features=eye[ids[:, :-1]], labels=eye[ids[:, 1:]])
    zip_path = os.path.join(tmp, "char_rnn.zip")
    before = lstm_counts()
    out, train_s = run(["train", "--conf", conf_path, "--input", npz,
                        "--output", zip_path, "--batch", str(TRAIN_BATCH)])
    counts = lstm_since(before)
    score = float(re.search(r"final score (\S+)\)", out).group(1))
    print(out.strip())
    trained = MultiLayerNetwork.load(zip_path, device=dev)
    print(f"cli train, char-RNN ({VOCAB}, 2 x {LSTM_H}, TBPTT {TBPTT}) on "
          f"{CLI_BATCHES} batches of {TRAIN_BATCH} x {SEQ}: {train_s:.2f} s "
          f"(zip written); final score {score!r}; iteration "
          f"{trained.iteration}; launches {counts}")
    check(np.isfinite(score), "cli train: the final score is not finite")
    check(trained.iteration == 2 * CLI_BATCHES,
          "cli train: not two TBPTT windows a batch")
    if dev.type == "cuda":
        check(counts["lstm_scan"] == counts["lstm_scan_bwd"]
              == 4 * CLI_BATCHES,
              "cli train: K1/K2 did not launch 4 times a fit")
        check(counts["lstm_scan_plain"] == 0
              and counts["lstm_scan_bwd_plain"] == 0,
              "cli train: a plain LSTM scan ran on the card")

    x, y = load_iris(seed)
    labels = y.argmax(1)
    iris_csv = os.path.join(tmp, "iris.csv")
    np.savetxt(iris_csv, np.column_stack([x, labels]), delimiter=",",
               fmt="%.6f")
    x_csv = os.path.join(tmp, "iris_x.csv")
    np.savetxt(x_csv, x, delimiter=",", fmt="%.6f")
    mlp = (NeuralNetConfiguration.builder().seed(seed).learning_rate(0.01)
           .updater("adam").list()
           .layer(0, L.DenseLayer(n_in=4, n_out=16, activation="tanh"))
           .layer(1, L.OutputLayer(n_in=16, n_out=3, activation="softmax",
                                   loss_function="mcxent"))
           .build())
    mlp_conf_path = os.path.join(tmp, "iris_mlp.json")
    with open(mlp_conf_path, "w") as f:
        f.write(mlp.to_json())
    iris_zip = os.path.join(tmp, "iris.zip")
    _, iris_train_s = run(["train", "--conf", mlp_conf_path, "--input",
                           iris_csv, "--output", iris_zip, "--epochs", "30",
                           "--batch", "16"])
    test_out, _ = run(["test", "--model", iris_zip, "--input", iris_csv])
    pred_in = os.path.join(tmp, "pred_in.csv")
    _, predict_s = run(["predict", "--model", iris_zip, "--input", x_csv,
                        "--output", pred_in])
    # the command line runs on the card (it has no device flag): on a CPU
    # rehearsal the subprocess leg is skipped
    pred_sub = os.path.join(tmp, "pred_sub.csv")
    with open(pred_in, "rb") as f:
        a = f.read()
    b, sub_s = a, None
    if dev.type == "cuda":
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "predict",
             "--model", iris_zip, "--input", x_csv, "--output", pred_sub],
            cwd=REPO_ROOT, env=dict(os.environ, PYTHONPATH=REPO_ROOT),
            capture_output=True, text=True, timeout=300)
        sub_s = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"cli predict subprocess failed: {proc.stderr[-2000:]}")
        with open(pred_sub, "rb") as f:
            b = f.read()
    acc = float((np.loadtxt(pred_in, delimiter=",").argmax(1)
                 == labels).mean())
    print(f"cli on iris ({len(x)} rows): train 30 epochs {iris_train_s:.2f}"
          f" s, predict in process {predict_s:.3f} s, as a subprocess "
          f"{sub_s} s; accuracy {acc!r}; subprocess CSV byte-equal: "
          f"{a == b} ({len(a)} bytes)")
    check("Accuracy" in test_out, "cli test printed no accuracy")
    check(acc >= 0.9, "cli: the iris MLP is below 0.9 accuracy")
    check(a == b, "cli: the subprocess predict CSV differs from the "
          "in-process one")
    return {"train_s": train_s, "final_score": score, "launches": counts,
            "iris_train_s": iris_train_s, "predict_s": predict_s,
            "subprocess_s": sub_s, "iris_accuracy": acc,
            "predict_bytes": len(a)}


class _ParamSnapshot:
    """A listener keeping, every ``every`` iterations, a copy of the
    params on their device (the histogram listener's input)."""

    def __init__(self, every: int):
        self.every = every
        self.last = None

    def iteration_done(self, model, iteration, score):
        if iteration % self.every == 0:
            self.last = (iteration, [{k: t.detach().clone()
                                      for k, t in p.items()}
                                     for p in model.params])


def ui_training(seed: int, dev, url: str, tmp: str) -> dict:
    """(c) first half: 8 char-RNN fits under the UI, performance, dispatch
    and trace listeners; 4 LeNet-5 fits under the convolutional one."""
    import logging

    from deeplearning4j_tpu_torch.optimize.listeners import (
        DispatchStatsListener,
        PerformanceListener,
    )
    from deeplearning4j_tpu_torch.parallel.stats import TrainingStats
    from deeplearning4j_tpu_torch.ui import (
        ConvolutionalIterationListener,
        FlowIterationListener,
        HistogramIterationListener,
    )
    from deeplearning4j_tpu_torch.utils.profiling import XplaneTraceListener

    net = full_char_rnn(seed, dev)
    snap = _ParamSnapshot(UI_EVERY)
    perf = PerformanceListener(frequency=UI_EVERY, batch_size=TRAIN_BATCH)
    disp = DispatchStatsListener(frequency=UI_EVERY)
    stats = TrainingStats()
    trace = XplaneTraceListener(os.path.join(tmp, "trace"), start_iteration=2,
                                num_iterations=3, stats=stats)
    net.set_listeners(
        HistogramIterationListener(frequency=UI_EVERY, server_url=url),
        snap, FlowIterationListener(frequency=UI_EVERY, server_url=url),
        perf, disp, trace)
    perf_lines = []

    class Grab(logging.Handler):
        def emit(self, record):
            if "iter/s" in record.getMessage():
                perf_lines.append(record.getMessage())

    log = logging.getLogger("deeplearning4j_tpu_torch")
    grab, level = Grab(), log.level
    log.addHandler(grab)
    log.setLevel(logging.INFO)
    ids = char_ids(seed + 12, TRAIN_BATCH, UI_FITS * SEQ + 1)
    eye = np.eye(VOCAB, dtype=np.float32)
    before = lstm_counts()
    try:
        t0 = time.perf_counter()
        for i in range(UI_FITS):
            sl = slice(i * SEQ, (i + 1) * SEQ)
            net.fit(eye[ids[:, sl]], eye[ids[:, 1:][:, sl]])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        log.removeHandler(grab)
        log.setLevel(level)
        trace.stop()
    counts = lstm_since(before)
    summary = _ok(_call(url, "/train/summary"), "GET /train/summary")
    hist = summary["histogram"]
    it, params = snap.last
    names = [f"{i}_{k}" for i, p in enumerate(params) for k in p]
    host = [t.cpu().numpy() for p in params for t in p.values()]
    hist_equal = hist["iteration"] == it
    for name, a in zip(names, host):
        counts_np, edges = np.histogram(a.reshape(-1), bins=20)
        h = hist["params"][name]
        hist_equal &= (h["counts"] == counts_np.tolist()
                       and h["lower"] == edges[:-1].tolist()
                       and h["upper"] == edges[1:].tolist())
    flow = summary["flow"]["layers"]
    with open(trace.path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    k1_in_trace = sum(K1_NAME in n for n in kernels)
    k2_in_trace = sum(any(k in n for k in K2_NAMES) for n in kernels)
    linked = [e.event_type for e in stats.events
              if e.event_type.startswith("xplane_trace:")]
    print(f"UI: {UI_FITS} char-RNN fits under the histogram, flow, "
          f"performance, dispatch and trace listeners in {wall:.2f} s; "
          f"launches {counts}; last histogram at iteration "
          f"{hist['iteration']} equal to numpy.histogram of the params "
          f"copied off the card then: {hist_equal}; flow "
          f"{[l['layer_type'] for l in flow]}; dispatch snapshots at "
          f"{[s['iteration'] for s in disp.snapshots]}; performance "
          f"windows: {perf_lines}")
    print(f"trace {os.path.basename(trace.path)} "
          f"({os.path.getsize(trace.path)} bytes, iterations 2-5): "
          f"{len(kernels)} kernel records, {k1_in_trace} of K1 "
          f"({K1_NAME}) and {k2_in_trace} of K2 ({'/'.join(K2_NAMES)}); "
          f"linked in TrainingStats: {linked}")
    check(hist_equal, "UI: the histogram differs from numpy's")
    check([l["layer_type"] for l in flow]
          == ["GravesLSTM", "GravesLSTM", "RnnOutputLayer"],
          "UI: the flow payload's layers")
    check(len(disp.snapshots) == UI_FITS, "UI: dispatch snapshots")
    check(linked, "UI: link_stats recorded no trace event")
    if dev.type == "cuda":
        check(counts["lstm_scan"] == counts["lstm_scan_bwd"] == 4 * UI_FITS
              and counts["lstm_scan_plain"] == 0
              and counts["lstm_scan_bwd_plain"] == 0,
              "UI: K1/K2 did not launch 4 times a fit, or a plain scan ran")
        check(k1_in_trace > 0 and k2_in_trace > 0,
              "UI: the profiler trace does not name K1's and K2's kernels")

    lenet = build_lenet5(device=dev, seed=seed)
    conv = ConvolutionalIterationListener(frequency=1, server_url=url)
    lenet.set_listeners(conv)
    xs, ys, _ = load_mnist_info(train=True, num_examples=64 * UI_LENET_FITS)
    t0 = time.perf_counter()
    for i in range(UI_LENET_FITS):
        sl = slice(i * 64, (i + 1) * 64)
        conv.set_input(xs[sl])
        lenet.fit(xs[sl], ys[sl])
    lenet_s = time.perf_counter() - t0
    grids = _ok(_call(url, "/train/summary"),
                "GET /train/summary")["activations"]["grids"]
    finite = all(np.isfinite(np.asarray(g)).all() for g in grids.values())
    print(f"UI: {UI_LENET_FITS} LeNet-5 fits at batch 64 with the "
          f"convolutional listener in {lenet_s:.2f} s: {len(grids)} "
          f"activation grids, all finite: {finite}")
    check(grids and finite, "UI: the convolutional payload")
    return {"fits_s": wall, "launches": counts, "histogram_equal": hist_equal,
            "trace_bytes": os.path.getsize(trace.path),
            "trace_kernel_records": len(kernels), "k1_in_trace": k1_in_trace,
            "k2_in_trace": k2_in_trace, "performance_windows": perf_lines,
            "lenet_s": lenet_s, "activation_grids": len(grids)}


def ui_explorers(seed: int, dev, url: str, w2v) -> dict:
    """(c) second half: ``/tsne/upload`` against a direct ``Tsne``, and
    ``/word2vec/nearest`` against a brute-force search."""
    from deeplearning4j_tpu_torch.plot.tsne import Tsne

    vocab, syn0 = w2v.vocab, w2v.lookup_table.syn0
    words = [vocab.word_at_index(i) for i in range(UI_TSNE_WORDS)]
    vecs = np.asarray(syn0[:UI_TSNE_WORDS], np.float32)
    t0 = time.perf_counter()
    got = _ok(_call(url, "/tsne/upload", {"words": words,
                                          "vectors": vecs.tolist(),
                                          "perplexity": 30.0}),
              "POST /tsne/upload")
    tsne_s = time.perf_counter() - t0
    coords = _ok(_call(url, "/tsne/coords"), "GET /tsne/coords")
    t0 = time.perf_counter()
    direct = Tsne(n_components=2, perplexity=30.0, max_iter=300,
                  device=dev).fit_transform(vecs)
    direct_s = time.perf_counter() - t0
    tsne_equal = coords["words"] == words and torch.equal(
        torch.tensor(coords["coords"], dtype=torch.float64),
        torch.from_numpy(np.asarray(direct, np.float64)))
    print(f"UI: POST /tsne/upload of {UI_TSNE_WORDS} words at perplexity "
          f"30: {got['points']} points in {tsne_s:.2f} s (HTTP and JSON "
          f"included); a direct Tsne(device={dev.type}) {direct_s:.2f} s; "
          f"coordinates torch.equal: {tsne_equal}")
    check(tsne_equal, "UI: the t-SNE coordinates differ from a direct Tsne")

    words = [vocab.word_at_index(i) for i in range(UI_NN_WORDS)]
    vecs = np.asarray(syn0[:UI_NN_WORDS], np.float32)
    t0 = time.perf_counter()
    _ok(_call(url, "/word2vec/upload", {"words": words,
                                        "vectors": vecs.tolist()}),
        "POST /word2vec/upload")
    upload_s = time.perf_counter() - t0
    unit = vecs.astype(np.float64)
    unit /= np.maximum(np.linalg.norm(unit, axis=1, keepdims=True), 1e-12)
    queries = np.random.default_rng(seed).choice(UI_NN_WORDS, UI_NN_QUERIES,
                                                 replace=False)
    mismatch, t_query = 0, 0.0
    for qi in queries:
        t0 = time.perf_counter()
        hits = _ok(_call(url, "/word2vec/nearest",
                         {"word": words[qi], "k": UI_NN_K}),
                   "POST /word2vec/nearest")["neighbors"]
        t_query += time.perf_counter() - t0
        d = np.linalg.norm(unit - unit[qi], axis=1)
        d[qi] = np.inf
        order = np.argsort(d, kind="stable")[:UI_NN_K]
        want = [words[j] for j in order]
        got_words = [h["word"] for h in hits]
        if got_words != want:
            # ties aside: every neighbour returned is as near as the
            # brute force's k-th
            kth = d[order[-1]]
            near = [d[words.index(w)] for w in got_words]
            if not (len(got_words) == UI_NN_K
                    and max(near) <= kth * (1 + 1e-12)):
                mismatch += 1
    ms = t_query / UI_NN_QUERIES * 1e3
    print(f"UI: POST /word2vec/upload of {UI_NN_WORDS} words "
          f"({vecs.shape[1]}-wide, the VPTree built on the host) "
          f"{upload_s:.2f} s; {UI_NN_QUERIES} /word2vec/nearest queries at "
          f"k = {UI_NN_K}: {ms:.2f} ms a query over HTTP; {mismatch} differ "
          f"from a brute-force cosine (normalized Euclidean) search")
    check(mismatch == 0, "UI: /word2vec/nearest differs from brute force")
    return {"tsne_s": tsne_s, "tsne_direct_s": direct_s,
            "tsne_equal": tsne_equal, "nn_upload_s": upload_s,
            "nn_ms_per_query": ms, "nn_mismatches": mismatch}


def tool_text(seed: int, dev, w2v) -> dict:
    """(d): the host text tools on the word2vec corpus."""
    from deeplearning4j_tpu_torch.nlp.invertedindex import InvertedIndex
    from deeplearning4j_tpu_torch.nlp.text_pipeline import TextPipeline
    from deeplearning4j_tpu_torch.nlp.treeparser import TreeParser
    from deeplearning4j_tpu_torch.nlp.vectorizers import TfidfVectorizer
    from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor

    corpus = topic_corpus(seed)
    texts = [" ".join(s) for s in corpus]
    t0 = time.perf_counter()
    tp = TextPipeline(min_word_frequency=W2V_MIN_COUNT,
                      num_partitions=8).fit(texts)
    tp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serial = VocabConstructor(W2V_MIN_COUNT).build(corpus)
    serial_s = time.perf_counter() - t0
    key = lambda v: [(w.word, w.count, w.index, list(w.codes),
                      list(w.points)) for w in v.vocab_words()]
    want = key(w2v.vocab)
    same = key(tp.vocab) == want and key(serial) == want
    print(f"TextPipeline(num_partitions=8) over {len(texts)} sentences "
          f"({sum(map(len, corpus))} tokens): {tp.vocab.num_words()} words "
          f"in {tp_s:.2f} s against the serial build's {serial_s:.2f} s; "
          f"vocab and Huffman codes equal to the word2vec phase's, word "
          f"for word and code for code: {same}")
    check(same, "TextPipeline's vocab or codes differ from build_vocab's")

    topics = sentence_topics(corpus)
    pick = np.flatnonzero(topics < TFIDF_TOPICS)
    sub = [texts[i] for i in pick]
    t0 = time.perf_counter()
    vec = TfidfVectorizer(min_word_frequency=2).fit(sub)
    ds = vec.vectorize(sub, [f"topic_{topics[i]}" for i in pick])
    vec_s = time.perf_counter() - t0
    width = ds.features.shape[1]
    conf = (NeuralNetConfiguration.builder().seed(seed).learning_rate(0.001)
            .updater("adam").list()
            .layer(0, L.DenseLayer(n_in=width, n_out=TFIDF_HIDDEN,
                                   activation="tanh"))
            .layer(1, L.OutputLayer(n_in=TFIDF_HIDDEN, n_out=TFIDF_TOPICS,
                                    activation="softmax",
                                    loss_function="mcxent"))
            .build())
    cpu_net = MultiLayerNetwork(conf, device="cpu").init()
    card_net = MultiLayerNetwork(copy.deepcopy(conf), device=dev).init()
    to_dev = lambda t: lowprec.tree_map(lambda a: a.to(dev, copy=True), t)
    card_net.params = to_dev(cpu_net.params)
    card_net.states = to_dev(cpu_net.states)
    card_net.updater_state = to_dev(cpu_net.updater_state)

    def losses(net):
        out = []
        for _ in range(2):
            for b in ListDataSetIterator(ds.features, ds.labels,
                                         TFIDF_BATCH):
                out.append(net.fit(b.features, b.labels))
        return torch.stack(out).to("cpu", torch.float64).numpy()

    t0 = time.perf_counter()
    card_losses = losses(card_net)
    card_s = time.perf_counter() - t0
    cpu_losses = losses(cpu_net)
    rel = float((np.abs(card_losses - cpu_losses)
                 / np.abs(cpu_losses)).max())
    print(f"TfidfVectorizer over the {len(sub)} sentences of "
          f"{TFIDF_TOPICS} topics: {width} features ({vec_s:.2f} s); MLP "
          f"{width}-{TFIDF_HIDDEN}-{TFIDF_TOPICS}, 2 epochs of "
          f"{len(card_losses) // 2} steps on the card in {card_s:.2f} s; "
          f"loss {float(card_losses[0])!r} -> {float(card_losses[-1])!r}; "
          f"max relative "
          f"deviation from the CPU fit {rel!r} (bar {TOL_TFIDF})")
    check(np.isfinite(card_losses).all() and card_losses[-1] < card_losses[0],
          "TF-IDF MLP: the loss did not fall")
    check(rel <= TOL_TFIDF, "TF-IDF MLP: the card's losses left the CPU's")

    parser = TreeParser()
    t0 = time.perf_counter()
    trees = [parser.get_trees(t) for t in texts[:PARSE_SENTENCES]]
    parse_s = time.perf_counter() - t0
    one_each = all(len(t) == 1 for t in trees)
    yields = all(t[0].yield_() == corpus[i] for i, t in enumerate(trees))
    print(f"TreeParser: {PARSE_SENTENCES} sentences of {W2V_SENT} words in "
          f"{parse_s:.2f} s ({parse_s / PARSE_SENTENCES * 1e3:.1f} ms a "
          f"sentence); one tree each: {one_each}; yields equal the "
          f"sentences: {yields}")
    check(one_each and yields, "TreeParser: not one tree per sentence")

    t0 = time.perf_counter()
    index = InvertedIndex()
    for s in corpus:
        index.add_words_to_doc(s)
    index_s = time.perf_counter() - t0
    sets = [set(s) for s in corpus]
    probe = [w2v.vocab.word_at_index(r) for r in INDEX_WORD_RANKS]
    t0 = time.perf_counter()
    found = [index.documents(w) for w in probe]
    lookup_ms = (time.perf_counter() - t0) / len(probe) * 1e3
    scan_equal = all(f == [i for i, s in enumerate(sets) if w in s]
                     for w, f in zip(probe, found))
    print(f"InvertedIndex of {len(corpus)} sentences built in "
          f"{index_s:.2f} s; {len(probe)} lookups ({lookup_ms:.3f} ms each, "
          f"{[len(f) for f in found]} documents) equal to a scan: "
          f"{scan_equal}")
    check(scan_equal, "InvertedIndex lookups differ from a scan")
    return {"text_pipeline_s": tp_s, "serial_vocab_s": serial_s,
            "vocab_equal": same, "tfidf_features": width,
            "tfidf_sentences": len(sub), "tfidf_card_s": card_s,
            "tfidf_losses_card": card_losses.tolist(),
            "tfidf_max_rel_dev": rel, "parse_s": parse_s,
            "index_s": index_s, "index_lookup_ms": lookup_ms}


def phase_tooling(seed: int, dev, w2v) -> tuple:
    """The tooling entry points on the card (module docstring, after the
    embeddings phase): (a) the north star, (b) the CLI, (c) the UI and
    its listeners with a profiler trace, (d) the host text tools.
    Returns (K1/K2 launches by part, the report)."""
    print("== the tooling: north star, CLI, UI, profiler, text tools ==")
    t_phase = time.perf_counter()
    rep = {"north_star": tool_north_star(dev)}
    with tempfile.TemporaryDirectory() as tmp:
        rep["cli"] = tool_cli(seed, dev, tmp)
        from deeplearning4j_tpu_torch.ui import UiServer

        server = UiServer(port=0, device=dev).start()
        try:
            rep["ui"] = ui_training(seed, dev, server.url, tmp)
            rep["ui"].update(ui_explorers(seed, dev, server.url, w2v))
        finally:
            server.stop()
    rep["text"] = tool_text(seed, dev, w2v)
    rep["wall_s"] = time.perf_counter() - t_phase
    print(f"tooling phase: {rep['wall_s']:.1f} s")
    launches = {part: rep[part]["launches"]
                for part in ("north_star", "cli", "ui")}
    return launches, rep


def tooling_rehearsal(seed: int = 0):
    """(a) and (d) of the tooling phase on the CPU: the north star's legs
    both on the CPU (deviation exactly 0) and the text tools against a
    vocab-only word2vec model. Run as ``python3 -c "import chip_smoke;
    chip_smoke.tooling_rehearsal()"``."""
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    ns = tool_north_star(cpu)
    for r in ns["results"].values():
        check(r["max_abs_deviation"] == 0.0,
              "CPU rehearsal: the north star is not deterministic")
    w2v = w2v_model(seed, cpu)
    w2v.build_vocab(topic_corpus(seed))
    text = tool_text(seed, cpu, w2v)
    print(f"CPU rehearsal of the tooling phase's (a) and (d), seed {seed}: "
          f"{time.perf_counter() - t0:.1f} s")
    return ns, text


def merge(times: dict, part: dict) -> None:
    """Fold one phase's timings into the report, key by key (several
    phases time a "main_path")."""
    for k, v in part.items():
        times.setdefault(k, {}).update(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the report as JSON here")
    # one run of the runtime phase's (a) in a child process (the phase
    # starts three); writes its report to --out
    ap.add_argument("--runtime-child", default=None,
                    choices=("uninterrupted", "preempted", "resumed"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--runtime-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if args.runtime_child:
        return runtime_child(args.runtime_child, args.seed,
                             args.runtime_dir, args.out)
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch.cuda.get_device_name(0): {kind}; torch {torch.__version__}"
          f", CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    sass = phase_build()
    with torch.inference_mode():
        errs = phase_kernels(args.seed, dev)
        errs.update(phase_kernels_sgns(args.seed, dev))
        errs.update(phase_kernels_ext(args.seed, dev))
        errs.update(phase_kernels_bwd(args.seed, dev))
    cfg = TransformerConfig(vocab_size=8192, d_model=2048, n_layers=4,
                            n_heads=32, d_ff=8192, max_len=1024,
                            dtype_policy="performance", use_flash=True,
                            seed=args.seed)
    torch.cuda.reset_peak_memory_stats()
    lm, widths, launches, serve, burst = phase_serve(cfg, args.seed, dev)
    with torch.inference_mode():
        times = phase_times(lm, widths, args.seed, dev)
    planes = phase_decode_planes(lm, burst, args.seed, dev)
    net, k1_launches, predict = phase_predict(args.seed, dev)
    merge(times, phase_times_predict(net, args.seed, dev))
    serving_planes = phase_serving_planes(lm, burst, args.seed, dev)
    obs_rep = phase_obs(lm, net, burst, args.seed, dev)
    peak_serve = torch.cuda.max_memory_allocated()
    tnet, train = phase_train(args.seed, dev)
    merge(times, phase_times_train(tnet, args.seed, dev))
    peak_train = torch.cuda.max_memory_allocated()
    del tnet
    w2v, chunk, word2vec = phase_word2vec(args.seed, dev)
    peak_w2v = torch.cuda.max_memory_allocated()
    merge(times, phase_times_word2vec(w2v, chunk, args.seed, dev))
    emb_launches, embeddings = phase_embeddings(args.seed, dev, w2v, cfg)
    tool_launches, tooling = phase_tooling(args.seed, dev, w2v)
    w2v_table = w2v.lookup_table  # /embed's lookup record
    del w2v, chunk
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        group = init_seq_group(os.path.join(tmp, "seq_store"), 0, 1,
                               backend="nccl")
        try:
            ring_counts, ring = phase_ring(args.seed, dev, group)
            rt_counts, uly_counts, ring_train = phase_ring_train(
                args.seed, dev, group)
        finally:
            dist.destroy_process_group()
    peak_rt = torch.cuda.max_memory_allocated()
    mha_counts, mha = phase_mha_train(args.seed, dev)
    with torch.inference_mode():
        merge(times, phase_times_ext(args.seed, dev))
    merge(times, phase_times_bwd(args.seed, dev))
    peak_sp = torch.cuda.max_memory_allocated()
    del lm
    _, lm_counts, lm_train = phase_lm_train(args.seed, dev)
    peak_lm = max(lm_train["peak_abs_bytes"],
                  torch.cuda.max_memory_allocated())
    bert_counts, bert_times, bert = phase_bert(args.seed, dev)
    peak_bert = torch.cuda.max_memory_allocated()
    cnn_counts, cnn = phase_cnn_zoo(args.seed, dev)
    peak_cnn = cnn["peak_memory_bytes"]
    graph_counts, graph = phase_graph(args.seed, dev)
    peak_graph = graph["peak_memory_bytes"]
    embed_counts, embed = phase_embed(args.seed, dev, w2v_table)
    del w2v_table
    torch.cuda.reset_peak_memory_stats()
    search_counts, search = phase_search(args.seed, dev, card)
    peak_search = torch.cuda.max_memory_allocated()
    runtime = phase_runtime(args.seed, dev)
    torch.cuda.reset_peak_memory_stats()
    dist_counts, distributed = phase_distributed(args.seed, dev)
    peak_dist = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fl_counts, fleet = phase_fleet(cfg, net, burst[0], args.seed, dev)
    peak_fleet = torch.cuda.max_memory_allocated()
    peak = max(peak_serve, peak_train, peak_w2v, peak_rt, peak_sp, peak_lm,
               peak_bert, peak_cnn, peak_graph, peak_search, peak_dist,
               peak_fleet, torch.cuda.max_memory_allocated())
    print(f"peak device memory allocated: {peak / 2**30:.3f} GiB (serving "
          f"phases {peak_serve / 2**30:.3f} GiB, char-RNN training phase "
          f"{peak_train / 2**30:.3f} GiB, the 30 fits "
          f"{train['fits_memory_bytes'] / 2**20:.1f} MiB more; word2vec "
          f"fit {peak_w2v / 2**30:.3f} GiB, "
          f"{word2vec['phase_memory_bytes'] / 2**20:.1f} MiB above what the "
          f"earlier phases hold; ring and ring training "
          f"{peak_rt / 2**30:.3f} GiB; MHA training, K5 and K7 timing "
          f"{peak_sp / 2**30:.3f} GiB; LM training "
          f"{peak_lm / 2**30:.3f} GiB; BERT {peak_bert / 2**30:.3f} GiB; "
          f"CNN and layer zoo {peak_cnn / 2**30:.3f} GiB; ComputationGraph "
          f"{peak_graph / 2**30:.3f} GiB; /search "
          f"{peak_search / 2**30:.3f} GiB; distributed "
          f"{peak_dist / 2**30:.3f} GiB; fleet {peak_fleet / 2**30:.3f} "
          f"GiB); "
          f"whole run "
          f"{time.perf_counter() - t_start:.1f} s")
    f4 = times["flash_attention"][max(FLASH_WIDTHS)]
    p6 = times["paged_attention"]
    p6q = times["paged_attention_f32q"]
    n1, t1, h1 = LSTM_SHAPES[0]
    k1 = times["lstm_scan"][f"{n1}x{t1}x{h1}"]
    n2, t2, h2 = BWD_SHAPES[0]
    k2 = times["lstm_scan_bwd"][f"{n2}x{t2}x{h2}"]
    k3 = times["sgns_step"]["x".join(map(str, SGNS_SHAPES[0]))]
    k3_floor = times["sgns_step"]["{}x{}x1x{}".format(
        SGNS_SHAPES[0][0], W2V_D, W2V_NEG + 1)]
    k5a, k5b, k5g, k5h = (times["flash_attention_block"][c]
                          for c in "abgh")
    k7, k7h = times["flash_bwd"]["train"], times["flash_bwd"]["h"]
    k5_bert, k7_bert = (bert_times["flash_attention_block"],
                        bert_times["flash_bwd"])
    # K4 is also held at the ring phase's shape (case g: Ulysses, forward)
    k4_err = max(errs["flash_attention"]["max_abs_err"],
                 *(c["k4_o"] for c in errs["flash_attention_block"]
                   ["causal_cases"].values()))
    k4_err_lse = max(errs["flash_attention"]["max_abs_err_lse"],
                     *(c["k4_lse"] for c in errs["flash_attention_block"]
                       ["causal_cases"].values()))
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "deeplearning4j_tpu_torch/csrc/flash_attention.cu",
         "replaces": "deeplearning4j_tpu/ops/pallas_attention.py:117",
         "launches": launches["flash_attention"],
         "launches_lm_train": lm_counts["flash_attention"],
         "launches_models_lifecycle": serving_planes["lifecycle"][
             "launches"]["flash_attention"],
         "launches_ulysses_train": uly_counts["flash_attention"],
         "launches_distributed_moe": dist_counts["flash_attention"],
         "launches_fleet": fl_counts["flash_attention"],
         "launches_embeddings": emb_launches["flash_attention"],
         "max_abs_err": k4_err, "max_abs_err_lse": k4_err_lse,
         "tolerance": TOL_FLASH_O,
         "ms": f4["ms"], "plain_ms": f4["plain_ms"],
         "bound_ms": f4["bound_ms"], "bound_by": f4["bound_by"],
         "library_ms": f4["library_ms"],
         "shape": f"N=1 T={max(FLASH_WIDTHS)} H={H} hd={HD} bf16 causal",
         "sass": sass,
         "design": "K5's launch with no bias, offset 0 or T: one template "
                   "(csrc/flash_fwd.cuh), bf16 wgmma, f32 3xTF32 on "
                   "mma.sync, a 2-stage cp.async K/V ring"},
        {"name": "paged_attention", "route": "cuda",
         "source": "deeplearning4j_tpu_torch/csrc/paged_attention.cu",
         "replaces": "deeplearning4j_tpu/ops/pallas_paged.py:145",
         "launches": launches["paged_attention"],
         "max_abs_err": errs["paged_attention"]["max_abs_err"],
         "tolerance": TOL_PAGED,
         "ms": p6["ms"], "plain_ms": p6["plain_ms"],
         "bound_ms": p6["bound_ms"], "bound_by": p6["bound_by"],
         "library_ms": None, "events_ms": p6["events_ms"],
         "gb_per_s": p6["gb_per_s"],
         "shape": f"S={LANES} bt={BT} m={M_TABLE} H={H} hd={HD} bf16, "
                  f"mean context {p6['mean_context']:.1f}",
         "one_long_lane": p6["one_long_lane"],
         "launches_k_step": planes["k_step"]["k4"][0]["launches"][
             "paged_attention"],
         "launches_spec": {m: r["launches"]["paged_attention"]
                           for m, r in planes["spec"].items()},
         "launches_handoff": planes["handoff"]["launches"][
             "paged_attention"],
         "launches_models_lifecycle": serving_planes["lifecycle"][
             "launches"]["paged_attention"],
         "launches_fleet": fl_counts["paged_attention"],
         "design": "context splits of 256 tokens (a grid axis) merged in "
                   "split order by a second kernel; 16-byte row reads, 8 "
                   "rounds of K and V in flight per warp"},
        {"name": "paged_attention_f32q_bf16kv", "route": "cuda",
         "source": "deeplearning4j_tpu_torch/csrc/paged_attention.cu",
         "replaces": "deeplearning4j_tpu/ops/pallas_paged.py:145",
         "instantiation": "launch_d<float, __nv_bfloat16>: f32 queries "
                          "over a bf16 arena (DL4J_TPU_SERVE_KV_DTYPE=bf16 "
                          "on an f32 model)",
         "launches": planes["kv_dtype"]["k6_launches_bf16"],
         "max_abs_err": errs["paged_attention_f32q"]["max_abs_err"],
         "tolerance": TOL_PAGED,
         "ms": p6q["ms"], "plain_ms": p6q["plain_ms"],
         "bound_ms": p6q["bound_ms"], "bound_by": p6q["bound_by"],
         "library_ms": None, "events_ms": p6q["events_ms"],
         "gb_per_s": p6q["gb_per_s"],
         "shape": f"S={LANES} bt={BT} m={M_TABLE} H={H} hd={HD} f32 q, "
                  f"bf16 arena, mean context {p6q['mean_context']:.1f}"},
        {"name": "lstm_scan", "route": "cuda",
         "source": "deeplearning4j_tpu_torch/csrc/lstm_scan.cu",
         "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:230",
         "launches": k1_launches["lstm_scan"],
         "launches_int8_predict": serving_planes["char_rnn"]["launches"][
             "int8"]["lstm_scan"],
         "launches_normalized_predict": serving_planes["normalized"][
             "launches_char_rnn"]["lstm_scan"],
         "launches_train": train["launches"]["lstm_scan"],
         "launches_cnn_zoo": cnn_counts["lstm_scan"],
         "launches_graph": graph_counts["lstm_scan"],
         "launches_runtime": {m: c["lstm_scan"] for m, c in
                              runtime["resilient"]["launches"].items()},
         "launches_distributed_averaging": dist_counts["lstm_scan"],
         "launches_fleet": fl_counts["lstm_scan"],
         "launches_tooling": {part: c["lstm_scan"]
                              for part, c in tool_launches.items()},
         "max_abs_err": errs["lstm_scan"]["max_abs_err"],
         "tolerance": TOL_LSTM,
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": None, "events_ms": k1["events_ms"],
         "floor_ms": k1["floor_ms"], "cudnn_lstm_ms": k1["cudnn_lstm_ms"],
         "sass": sass["lstm_scan"],
         "shape": f"N={n1} T={t1} H={h1} f32",
         "design": "one cluster of 16 (or 8) CTAs per block of batch rows, "
                   "U's column slice in shared memory, h through "
                   "distributed shared memory (st.async counted on the "
                   "receiver's mbarrier)"},
        {"name": "lstm_scan_bwd", "route": "cuda",
         "source": "deeplearning4j_tpu_torch/csrc/lstm_scan_bwd.cu",
         "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:396",
         "launches": train["launches"]["lstm_scan_bwd"],
         "launches_cnn_zoo": cnn_counts["lstm_scan_bwd"],
         "launches_graph": graph_counts["lstm_scan_bwd"],
         "launches_runtime": {m: c["lstm_scan_bwd"] for m, c in
                              runtime["resilient"]["launches"].items()},
         "launches_distributed_averaging": dist_counts["lstm_scan_bwd"],
         "launches_fleet": fl_counts["lstm_scan_bwd"],
         "launches_tooling": {part: c["lstm_scan_bwd"]
                              for part, c in tool_launches.items()},
         "max_abs_err": errs["lstm_scan_bwd"]["max_abs_err"],
         "max_err_checked": errs["lstm_scan_bwd"]["max_err"],
         "tolerance": TOL_LSTM_BWD,
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None, "events_ms": k2["events_ms"],
         "floor_ms": k2["floor_ms"], "sass": sass["lstm_scan_bwd"],
         "shape": f"N={n2} T={t2} H={h2} f32",
         "design": "the gate recompute and dU as products over the card; "
                   "the sweep on K1's clusters, partial dz U^T "
                   "reduce-scattered through distributed shared memory"},
        {"name": "sgns_step", "route": "cuda",
         "source": "deeplearning4j_tpu_torch/csrc/sgns.cu",
         "replaces": "deeplearning4j_tpu/ops/pallas_sgns.py:159",
         "launches": word2vec["launches"]["sgns_step"],
         "launches_fleet": fl_counts["sgns_step"],
         "launches_embeddings": emb_launches["sgns_step"],
         "max_abs_err": errs["sgns_step"]["max_err"],
         "max_err_is": "of the largest entry of each table's update",
         "tolerance": TOL_SGNS,
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "bound_per_entry_ms": k3["bound_per_entry_ms"],
         "library_ms": None, "events_ms": k3["events_ms"],
         "launches_per_call": k3["launches_per_call"],
         "floor_ms": k3_floor["ms"],
         "v64_ms": times["sgns_step"][f"64x{W2V_D}x{W2V_BATCH}x{W2V_NEG + 1}"]
         ["ms"],
         "shape": "V={} D={} B={} K+1={} f32".format(*SGNS_SHAPES[0]),
         "design": "two launches: a warp per pair gathers into scratch and "
                   "puts each hit on its row's owner (integer atomics); "
                   "each owner sums its row's hits in batch order (its CTA "
                   "for more than 32) and adds once; no float atomics"},
        {"name": "flash_attention_block", "route": "cuda",
         "source": "deeplearning4j_tpu_torch/csrc/flash_attention_ext.cu",
         "replaces": "deeplearning4j_tpu/ops/pallas_attention.py:289",
         "launches": ring_counts["flash_attention_block"],
         "launches_mha_train": mha_counts["flash_attention_block"],
         "launches_ring_train": rt_counts["flash_attention_block"],
         "launches_bert": bert_counts["flash_attention_block"],
         "launches_embed": embed_counts["flash_attention_block"],
         "launches_search": search_counts["flash_attention_block"],
         "max_abs_err": max(errs["flash_attention_block"]["max_abs_err"],
                            k5_bert["max_err"]),
         "max_abs_err_lse": max(
             errs["flash_attention_block"]["max_abs_err_lse"],
             k5_bert["max_err_lse"]),
         "max_abs_err_ring": errs["flash_attention_block"][
             "max_abs_err_ring"],
         "tolerance": TOL_FLASH_O,
         "ms": k5a["ms"], "plain_ms": k5a["plain_ms"],
         "bound_ms": k5a["bound_ms"], "bound_by": k5a["bound_by"],
         "library_ms": k5a["library_ms"], "shape": k5a["shape"],
         "case_b": k5b, "case_g": k5g, "case_h": k5h, "case_bert": k5_bert,
         "sass": sass,
         "design": "bf16: wgmma m64nNk16, P from registers (bf16 hi + lo); "
                   "f32: 3xTF32 on mma.sync m16n8k8, operands split in "
                   "registers; a 2-stage cp.async K/V ring, masking only "
                   "where needed",
         "causal_cases": errs["flash_attention_block"]["causal_cases"]},
        {"name": "flash_bwd", "route": "cuda",
         "source": "deeplearning4j_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "deeplearning4j_tpu/ops/pallas_attention.py:176 "
                     "(_flash_bwd, XLA; and _flash_ext_bwd :335)",
         "launches": lm_counts["flash_bwd"],
         "launches_mha_train": mha_counts["flash_bwd"],
         "launches_ring_train": rt_counts["flash_bwd"],
         "launches_ulysses_train": uly_counts["flash_bwd"],
         "launches_bert": bert_counts["flash_bwd"],
         "launches_distributed_moe": dist_counts["flash_bwd"],
         "max_abs_err": max(errs["flash_bwd"]["max_err"], k7_bert["max_err"],
                            *(c["max_err_vs_plain_chain"] for c in
                              ring_train["ring_backward"].values())),
         "max_err_is": "of the largest entry of each gradient",
         "tolerance": TOL_BWD_BF16, "tolerance_f32": TOL_BWD_F32,
         "cases": errs["flash_bwd"]["cases"],
         "ms": k7["ms"], "plain_ms": k7["plain_ms"],
         "bound_ms": k7["bound_ms"], "bound_by": k7["bound_by"],
         "library_ms": k7["library_ms"], "events_ms": k7["events_ms"],
         "launches_per_call": k7["launches_per_call"],
         "shape": k7["shape"], "case_h": k7h, "case_bert": k7_bert,
         "ring_backward": ring_train["ring_backward"],
         "sass": sass["flash_bwd"],
         "design": "two passes, no float atomics: a CTA per q tile "
                   "writes dQ (and Dvec), a CTA per 64-key tile dK and dV; "
                   "P recomputed in both; bf16 wgmma (P and dS from the "
                   "accumulators), f32 3xTF32 mma.sync m16n8k8; a 2-stage "
                   "cp.async ring; hidden tiles skipped"},
    ]
    if args.out:
        report = {"card": card, "kind": kind, "kernels": kernels,
                  "serving": serve, "decode_planes": planes,
                  "serving_planes": serving_planes,
                  "predict": predict, "train": train,
                  "word2vec": word2vec, "ring": ring,
                  "ring_train": ring_train, "mha_train": mha,
                  "lm_train": lm_train, "bert": bert, "cnn_zoo": cnn,
                  "graph": graph, "embed": embed, "search": search,
                  "obs": obs_rep, "runtime": runtime,
                  "distributed": distributed, "fleet": fleet,
                  "embeddings": embeddings,
                  "tooling": tooling,
                  "times": times,
                  "peak_memory_bytes": peak}
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
