"""Smoke run of sie_tpu_torch on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final `ok` line:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel source of the package, in parallel;
     ptxas's registers and spills of each instantiation beside its SASS
     counts of HGMMA (wgmma) and HMMA (mma.sync) instructions
     (`cuobjdump -sass`); fails unless each of the 45 bf16 attention
     instantiations (K5/K6, K9, K10) has HGMMA and no HMMA; the FP32, ALU and LDS
     instructions of the inner loop of each shapelet kernel's flagship
     instantiation (K1/K3 10, K2/K4 5 shapelet rows a block);
  3. K1 (shapelet distance) against its plain version at the flagship
     shapes: B=64, C=122, T=845, n=10, each of the six banks, both metrics;
     kernel, plain and torch.cdist times, the bound and the issue-slot
     floor (two instructions a tap);
  4. K5 (fused attention) against its plain version at BH=512, T=845,
     dk=64 in bf16 and f32, and at a ragged T=300; kernel, plain and
     scaled_dot_product_attention times and the bound;
  5. serving: the flagship InterpGN (weights from seed 0) behind
     `Predictor` on the card answers requests of 1, 5, 64 and 150 rows
     (max_batch 64), three of each, with launch counts checked per chunk
     of every request (K1 6, K5 2, no other kernel); the median time of
     each size is printed; its logits are held against the plain CPU path
     on 2 rows;
  6. K5 with dropout (rate 0.1) against its plain version at BH=512, T=845,
     dk=64 in bf16 and f32; its row log-sum-exp output; times at rate 0.1
     and rate 0;
  7. K2 (shapelet-distance backward) against its plain version at B=64 on
     each of the six banks, both metrics, random output gradients, and
     against itself (deterministic); kernel and plain times, the bound and
     the issue-slot floor; the library time, the bank gradient through
     torch.cdist(p=1) in calls of fewer batch rows, halved at each fault
     until they run, summed per bank and timed in child processes (a fault
     there cannot reach this one's CUDA context), kept only if all six
     banks run;
  8. K6 (attention backward) against its plain version at BH=512, T=845,
     dk=64 in bf16 and f32 and at a ragged T=300, rates 0 and 0.1; kernel,
     plain and scaled_dot_product_attention-backward times and the bound;
  9. training: the flagship InterpGN under `Trainer` on the card, 256 rows
     held there, B=64: 3 warm-up and 10 timed steps, each checked for its
     kernel launches (K1 6, K2 6, K5 2, K6 2), a finite loss and moved
     weights; the median step time, the full/sbm/dnn fwd+bwd split and the
     optimizer's share; a step at dropout 0.1; the card's gradients held
     against the plain CPU path's on 2 rows;
 10. K3 and K4 (the six flagship banks in one launch, `fuse_short_banks`):
     K3 equal bit for bit to six K1 launches and K4 to six K2 launches
     (random output gradients), K4 equal to itself on a second run, both
     against their plain versions; K3 against the sum of the six K1 times
     and K4 against the six K2 times, the bound and the issue-slot floor;
 11. the flagship with `fuse_short_banks=True`, at the same weights:
     served (1, 5, 64, 150 rows; K3 1 and K5 2 launches per chunk, no
     other kernel; logits equal to the unfused predictor's on the card) and
     trained (3 warm-up and 5 timed steps; K3 1, K4 1, K5 2, K6 2 launches
     a step; gradients on 2 rows equal to the unfused card path's, bit for
     bit);
 12. K5 and K6 at the long-sequence shape of an EigenWorms-shaped model
     (BH=64 = 8 rows x 8 heads, T=17984, dk=64), where the JAX package runs
     its kv-blocked kernels K7, K8a and K8b: bf16 and f32, rates 0 and 0.1,
     held against the chunked plain versions on the first 2 heads (both
     kernels within their limit times max|want|), the
     log-sum-exp against torch.logsumexp; kernel, plain (chunked, all
     heads) and scaled_dot_product_attention times, the bound, and the
     device time of K6's dQ pass (K8a) and dK/dV pass (K8b) from
     torch.profiler;
 13. training the EigenWorms-shaped InterpGN (T=17984, 6 channels, 5
     classes, float32, `fused_attention_max_len=0`, B=8) under `Trainer`:
     2 warm-up and 5 timed steps, each checked for its launches (K1 and K2
     once per polyphase component of the six strided banks, K5 2, K6 2), a
     finite loss and moved weights; the median step time; a step at
     dropout 0.1;
 14. the staged steps as CUDA graphs (`Trainer.stage_steps`,
     `train_step_staged`, `train_epoch_staged`, `eval_epoch_staged_scan`)
     against the eager indexed steps at the flagship's width with dropout
     0.1, from the same weights and generator state: 10 steps in turns
     (eager, then the same step as a graph: warm-up, capture, replays) and
     two scanned epochs of 5 (warm-up, captured); losses within 1e-5
     relative, parameters within 2.1 x lr (and whether bit-equal); each
     captured graph's launches (a step K1 6, K2 6, K5 2, K6 2; an epoch 5
     times that; the fused flagship's step K3 1, K4 1, K5 2, K6 2; an eval
     pass K1 6, K5 2 a batch); the scanned eval pass against the eager
     eval step (logits within 5e-2, same argmax); the median eager and
     graph step times;
 15. the flagship experiment through the command line, in this process
     (`sie_tpu_torch.run.main`): synthetic CHISCO (640 trials, 122
     channels, 1651 samples cropped to 845; 448 training rows), InterpGN +
     Transformer at full width, amp, 3 epochs; finite epoch losses, the
     test accuracy and CSV, CUDA graphs captured, every kernel of the path
     launched (counts read over this first run); a re-run that skips
     training and gives the same test accuracy; a run under --scan_epoch;
 16. InterpGN + FCN as run_uea.sh trains it (f32, num_shapelet 10,
     lambda_div and lambda_reg 0.1, epsilon 1, gating_value 1, lr 5e-3)
     at the EigenWorms shape (6 channels, 17984 steps, 5 classes), B=8:
     6 eager `train_step_indexed` steps, each followed by the same step
     through `train_step_staged` (warm-up, capture, replays) from the same
     weights and generator state; each eager step, the warm-up and the
     capture launch K1 = K2 = the polyphase components of the strided banks
     and no other kernel; losses, parameters and BatchNorm buffers of the
     graph bit-equal to eager after every step; every parameter and buffer
     moved; eval logits of 2 rows against the CPU plain path within 1e-4,
     buffers unmoved by eval; the median eager and graph step times;
 17. the same with dnn_type ResNet, 3 steps, graph against eager within
     1e-5 (losses) and 2.1 x lr (tensors);
 18. EEGCNN as bench.py's second configuration times it (CHISCO shape,
     B=64, amp, the eegcnn_* defaults, d_model 512): 8 eager steps against
     graph steps at dropout 0, bit-equal, no kernel launched; 3 at the
     config's dropout 0.1 within the limits above; a 64-row request
     through `Predictor(cfg, variables)` from the trained model's
     flax-layout variables (batch_stats included) against the CPU plain
     path within 5e-2, same classes; request and step medians;
 19. the command line with BatchNorm: run_uea.sh's command (InterpGN +
     FCN, --no-amp, its shapelet flags) on a synthetic UEA set at
     SelfRegulationSCP2's shape (7 x 1152, 2 classes, 200/180 cases),
     B=32, 3 epochs; and `--model EEGCNN` on synthetic CHISCO, 2 epochs;
     each trains with finite losses and tests, its checkpoint holds
     batch_stats under the flax names, and a re-run skips training at the
     same test accuracy;
 20. bundles: phase 15's command again (training skipped) with
     --export_bundle and with --quantize_bundle; both loaded with
     `Predictor.load_bundle` on the card (max_batch 64), their device bytes
     after load beside the parameter count (the int8 leaves must hold
     <= 0.3 of their f32 bytes); requests of 1, 5, 64 and 150 rows (K1 6,
     K5 2 a chunk, no other kernel); the f32 bundle's logits bit-equal to
     the experiment's checkpoint served in this process
     (`Predictor.from_checkpoint`), the int8 bundle's within
     tests/test_quant.py's limits (logits 0.05 abs + 0.05 rel, probs 0.02)
     and no class flipped where f32's top two logits are further apart
     than twice the error; `calibrate` on the validation rows, saved and
     reloaded at the same T; median ms a request of each bundle;
 21. HTTP: `python -m sie_tpu_torch.serve_http --bundle DIR --max_batch 64
     --warmup 1 64` on a free local port: /healthz, /config; JSON-list
     requests of 1 and 5 rows, x_b64 and npz requests of 1, 5, 64 and 150
     rows, every output within 1e-6 of the in-process bundle predictor;
     fields=["probs"]; a malformed body answered 400; /metrics counting
     the requests and the error; the port's InferenceClient; median ms at
     1 row (JSON lists) and 1 and 64 rows (x_b64 in a JSON body, and npz)
     beside the in-process times; then a batching server in this process
     (window 20 ms): 8 concurrent 8-row requests in fewer dispatches, one
     K1/K5 set each, each request's logits within 5e-2 of it served alone;
 22. export: the f32 bundle's predictor through `export_stablehlo` for
     buckets (1, 64); a fresh process that imports sie_tpu_torch.ops and
     sie_tpu_torch.serve and no model code (checked on sys.modules) serves
     it through `CompiledPredictor`: 6 `sie_tpu_torch::l1_fwd` and 2
     `attention_fwd` nodes in the graph, K1 6 and K5 2 launches a chunk,
     logits within 5e-2 of the live predictor with the same classes; then
     `serve_http --stablehlo DIR` answers one request within 1e-6 of it;
 23. augmentation: the flagship at dropout 0.1 with `augment` noise,
     scale, chdrop and tshift: 5 eager indexed steps against the same
     steps through `train_step_staged` (warm-up, capture, replays) from the
     same weights and generators, losses and parameters bit-equal; K1 6,
     K2 6, K5 2, K6 2 a step (warm-up and capture too; none at a replay);
     one batch's draws within 5-sigma normal and binomial bounds (noise
     mean and std, the chdrop keep rate, offsets in [-16, 16]), the added
     noise's std against 0.1 x each row's valid-region std, padding exactly
     zero; eval logits with and without augment bit-equal; the median
     replayed step with and without augment, in turns;
 24. regression through the command line: `--task_name regression --data
     Monash` on a synthetic archive at BIDMC32HR's shape (2 x 4000,
     subsampled x4 to T = 1000; 512/256 cases), InterpGN + Transformer at
     full width, 10 bins, amp, B=64, 3 epochs: each train step K1 6, K2 6,
     K5 2, K6 2; finite CRPS losses that move (lr 1e-5: at 5e-3 the head
     saturates in one step); CSV and checkpoint.msgpack; a re-run that
     skips training with the same test loss; logits and CRPS of 2 test
     rows against the CPU plain path within 5e-2 at the seed-0 weights
     (at the trained ones the CRPS within 5e-2 and the logits within 5e-2
     x their largest magnitude); K1/K2 against their
     plain versions at C = 2, T = 1000 and the six banks (L 50 ... 800);
     the median step;
 25. reference checkpoints: phase 15's and phase 24's checkpoints through
     `--export_torch_ckpt`, read back through `--import_torch_ckpt` on the
     card (no training): the same test accuracy / test loss, and the
     file's keys and shapes equal to `export_state_dict` on the CPU;
 26. LOSO: `--loso --max_subjects 3` on synthetic CHISCO (384 trials) at
     the flagship's width, 1 epoch a fold: three folds with finite losses,
     each fold's test rows exactly its subject's, checkpoints under
     loso-<subject>, the fold mean printed;
 27. InterpGN + PatchTST at full width (B 64, T 845, C 122, d_model 512,
     d_ff 2048, 8 heads, 2 layers, six banks of 10, amp, dropout 0.1, 4
     chunks of 1952 series recomputed in the backward pass): 4 eager
     steps against the same steps as graphs, bit for bit (the recompute
     under capture replays the dropout masks), K1 6 and K2 6 a step and
     no K5/K6 under the default gate; eval logits of 2 rows at the seed-0
     weights against the CPU plain path; gradients with patch_remat true and false bit-equal
     (B 16, chunks of 512); K5 + K6 against the plain branch and
     scaled_dot_product_attention at the chunk's shape (BH 15616, T 105,
     dk 64, bf16), forward and backward, and against their plain versions
     at rate 0.1; a step with fused_attention_min_len=0 (K5 16: two
     layers over four chunks, forward and recompute; K6 8); K5/K6 at BH
     65544 against the chunked plain versions; step medians and peak
     memory;
 28. InterpGN + TimesNet (d_model 32, d_ff 32, top_k 5, num_kernels 6, 2
     blocks, the flagship's data shape, amp, dropout 0.1): 4 eager steps
     against graph steps, bit for bit, K1 6 and K2 6 a step;
     `fft_periods` on 2 rows with clear peaks equal on the card and the
     CPU, and the seed-0 weights' logits within 5e-2 of the CPU plain
     path; one forward
     and backward at width 512/2048 on B 8, its time and peak memory, its
     logits within 5e-2 of the same weights without amp;
 29. both backbones through the command line on synthetic CHISCO, 1
     epoch: CSV, checkpoint and graphs; a re-run that skips training with
     --export_torch_ckpt and a run with --import_torch_ckpt at the same
     accuracy and test loss; f32 and int8 bundles of the checkpoint
     against the live weights at 64 rows (1e-4; phase 20's int8 limits);
     --debug_nans (PatchTST with --profile_dir): the same losses as the
     plain run, bit for bit, and K1 and K2 in the trace; a NaN inside a
     train row's
     valid region raising FloatingPointError that names the step and an
     op;
 30. streaming: phase 15's command for 1 epoch held on the device and
     with --stream_from_disk: three stream_EEG3_* memmap caches under
     --cache_dir, the streamed run's train losses and test accuracy
     bit-equal to the in-memory run's (anything else fails), a re-run
     that opens the caches without calling the registry loader (its calls
     counted), each prefetched batch of an epoch equal to a plain copy of
     its rows; ms a step
     and idle share of the host-fed streamed steps (pinned copies on a
     side stream) against device-resident replays, and the host RSS
     growth while streaming against the train split's bytes on disk;
 31. the task models at run.py's default widths (d_model 512, 8 heads, 2
     encoder and 1 decoder layers, d_ff 2048, amp; TimesNet at 32/32,
     top_k 5, 6 kernels), B 32, lr 1e-4, 5 eager steps each from seed-0
     weights with finite losses, moved weights and the first step's loss
     within 5e-2 relative of the CPU plain path on the same batch (and
     keep mask): (a) long-term forecasting on an ETTh1-shaped file
     (17420 hourly rows, seq_len 96, label_len 48, pred_len 96), all
     three backbones, no kernel launched; (b) the Transformer at seq_len
     336: K5 2 and K6 2 a step, nothing else, then K5 and K6 at its
     encoder's shape (BH 256, T 336, bf16, rates 0 and 0.1) against
     their plain versions, timed beside them and SDPA; (c) imputation,
     mask_rate 0.25, all three; (d) anomaly detection on an SMD-shaped set (38
     channels, 28479 train and test rows, ~4 % labelled), seq_len 100,
     all three; (e) short-term forecasting on a synthetic M4 Monthly
     group (2000 series), seq_len 36, Transformer and TimesNet; the
     median step and idle share of each;
 32. the four tasks through the command line, 1 epoch each: the pickle,
     M4's forecast CSV read back by the port's M4Summary with a Naive2
     file, the anomaly run's precision, recall and F1;
 33. (a) the flagship with a Switch-MoE FFN in each encoder layer (8
     experts, top-1, capacity factor 1.25, aux weight 0.01, dropout 0.1;
     scripts/onchip_cert.py's MoE) at full width, B 64: 4 eager steps
     against the same captured staged steps, bit for bit, K1 6, K2 6, K5
     2, K6 2 a step; 10 replays after warm-up, capture and one replay,
     their median and idle share beside the dense flagship's; the first
     loss (with the aux term) and every gradient on 2 rows against the
     CPU plain path; 64 rows served (K1 6, K5 2), 4 of them against the
     CPU; one top-2 step at B 16;
 34. (b) the attention variants ds, prob and lsh in the flagship encoder
     (dropout 0.1): 3 eager steps each, K1 6 and K2 6 a step and no K5/K6;
     eval logits of 2 rows against the CPU plain path;
 35. (c) InterpGN with each of Autoformer, FEDformer, ETSformer,
     Pyraformer and Crossformer as its expert (scripts/onchip_cert.py's
     configuration: d_model 128, d_ff 256, 8 heads, 2 layers, B 16,
     dropout 0.1, amp): 5 eager steps against 5 staged ones (warm-up,
     capture, 3 replays), bit for bit, K1 6 and K2 6 a step; the first
     loss on 2 rows against the CPU plain path; a 16-row request;
 36. (d) the five forecasters at phase 31 (a)'s settings, 5 eager steps
     each, first loss against the CPU; one imputation and one anomaly
     step of each dense head; --dnn_type FEDformer through the CLI on
     the forecast task for 1 epoch;
 37. (a) the multi-seed ensemble (train/ensemble.py) at the flagship's
     width: five seeds (DEFAULT_SEEDS) trained as one captured step, each
     on its own schedule over 640 numpy-seeded rows held on the card, B
     64 a seed, dropout 0.1: the warm-up and the capture launch K1 30, K2
     30, K5 10, K6 10 and a replay nothing; after 5 steps every seed's
     losses, parameters and Adam state equal a lone Trainer's graph
     replays of that seed, bit for bit; the median of 10 replays and its
     idle share beside the sum of the lone replays' medians; the peak
     memory of 5 seeds and of 1; seed 42 stopped at step 3 stays frozen
     (parameters, moments, count) while the others move, without a new
     capture;
 38. (b) the UEA sweep: a SelfRegulationSCP2-shaped synthetic archive (7
     channels x 1152, 200 train and 180 test cases, noise added) through
     scripts/port_uea_ensemble_sweep.py with run_uea.sh's flags (InterpGN
     + FCN, f32, 6 epochs at patience 2) and a missing dataset beside it:
     parsed by the native .ts scanner, K1 30 and K2 30 a step (warm-up and
     capture) and no K5/K6, the missing dataset skipped, each seed's
     result equal to a driver run of that seed alone, a seed stopped
     early; the sweep's seconds against the five lone runs';
 39. the mesh (parallel/, each part a check of its own): (a) the
     flagship at dropout 0.1 on a one-process NCCL group and `Mesh((1,),
     ("data",))`: 5 staged steps (warm-up, capture, replays) bit-equal to
     the trainer without a mesh, losses and parameters, K1 6, K2 6, K5 2,
     K6 2 at warm-up and capture, the capture holding its 4 all-reduces;
     10 replays of each in turns, their medians; (b) 'data' over two
     processes that share the card (gloo, the launch variables): the
     flagship in f32 at dropout 0, B 64 split 32/32, 3 eager steps of
     `train_step` on global batches: the losses (rtol 1e-5, atol 1e-6)
     and the parameters (rtol 1e-5, atol 1e-6 where every step's gradient
     is >= 1e-4, else 2.1 lr a step) of one process on the global batch,
     ms a global step; (c) the same over 'model': banks of 5 shapelets
     (K1/K2), 4 heads (K5/K6 over 256 rows) and 1024 FFN columns a rank;
     (d) phase 26's --loso command as two processes through `python -m
     sie_tpu_torch.run`: disjoint folds that cover the 3 subjects, each
     fold's accuracy phase 26's; (e) `Predictor` over `Mesh((1,),
     ("data",), devices=["cuda:0"])` at 1, 5 and 64 rows, every output
     bit-equal to the predictor without a mesh, K1 6 and K5 2 a request;
 40. the 'seq' and 'expert' mesh axes (each part a check of its own):
     (a) 'seq' over two processes that share the card (gloo, the launch
     variables): the flagship in f32 at T 844 (845 does not split over
     2), dropout 0, B 64, 3 eager steps of `train_step` on global batches
     against one process (phase 39's limits), K1 6, K2 6, K5 2, K6 2 a
     step on rank 0, K5 at (512 rows, T 844); (b) 'expert' in the same
     pair of processes: the MoE flagship (8 experts, 4 a rank) at T 845,
     held the same way; (c) `python -m sie_tpu_torch.run --mesh 2
     --mesh_axes seq` with InterpGN + FCN in f32 on synthetic UEA (T 200)
     as two processes on the card: test accuracy equal to one process's
     and test loss within 1e-4; (d) `--mesh 2` with long_term_forecast
     trains in this one process and says the mesh is ignored; (e)
     `Predictor` over single-process ('data', 'seq') and ('data',
     'expert') meshes at 1, 5, 64 rows, bit-equal to the predictor
     without a mesh, K1 6 and K5 2 a request;
 41. the 'pipe' axis (each part a check of its own): (a) the flagship's
     encoder (d_model 512, 8 heads, d_ff 2048, 2 layers, one a stage)
     through parallel/pipeline.py over ('pipe',) 2, two processes that
     share the card (gloo), B 64, T 845, 4 microbatches, in f32 and bf16
     amp: the forward and the gradients of sum(sin(out)) (each stage's
     leaves, the input's on stage 0, zeros on stage 1) against the
     sequential encoder at the same weights (1e-4 f32, 5e-2 bf16, x max
     |want|, per leaf), K5 5 a forward at (128 rows, T 845) and K6 5 a
     backward on each rank, ms of a forward + backward against the
     sequential one's; (b) 'pipe' in the Trainer, in the same pair of
     processes: the flagship in f32, 3 eager steps of `train_step`,
     nothing split, losses and parameters bit-equal to one process (else
     the gap, within phase 39's limits), K1 6, K2 6, K5 2, K6 2 a step on
     rank 0; (c) the MoE flagship encoder pipelined in training: its aux
     within 1e-5 of the mean over microbatches of the sequential layers'
     summed aux, the output within 1e-4, a finite backward, ValueError
     ('load-balance') without the aux; (d) the flagship Trainer at
     dropout 0.1 takes 2 steps, writes `train_state.msgpack` in the JAX
     package's layout, a new trainer loads it and takes 2 more, bit-equal
     to 4 uninterrupted steps;
 42. `use_flash_attention` (each part a check of its own): (k) K9, K10b
     and K10a (the stock flash kernels' counterparts, ops/flash.py)
     against their plain versions at the flagship's attention (BH 512, T
     845, dk 64), dk 128 (BH 256) and 256 (BH 128), PatchTST's chunk (BH
     15616, T 105) and the EigenWorms shape (BH 64, T 17984; the first 2
     heads against the chunked plain versions): outputs, gradients, the
     row log-sum-exp and di, the forward and the backward bit for bit
     twice; each kernel's ms beside its bound, the plain versions' and
     SDPA's, with the flash backend forced and with its default
     choice; (a) the flagship with the flag (dropout 0,
     amp, B 64): eager steps against graph replays bit for bit, K1 6, K2
     6, K9 2, K10a 2, K10b 2 a step and no K5 or K6, the first loss and
     gradients against the CPU plain path, replay ms beside the same
     model without the flag; (b) the flag at dropout 0.1: a training step
     takes K5 2, K6 2, its Predictor K9 2 (no K5) a request of 64 rows;
     (c) the EigenWorms-shaped InterpGN in amp with the flag at the
     default fused_attention_max_len 4096: 3 steps, K9 2, K10a 2, K10b 2
     each, finite losses, moved weights, peak memory;
 43. one JSON line of per-kernel numbers (K1 ... K10b; launches from the
     timed training steps of each kernel's path, plus, split in
     `launches_by_path`, phases 16, 17 and 19's UEA run for K1 and K2, the
     serving paths for K1, K3 and K5: phase 5, phase 11's requests, phase
     20's bundles and phase 22's exported program, phases 23, 24, 26 and
     30 for K1, K2, K5 and K6, phases 27-29 for K1 and K2, phase 31 (b)
     for K5 and K6 as `forecast_long`, phase 33 for K1, K2, K5 and K6 as
     `moe`, phases 34 and 35 for K1 and K2 as `variants` and
     `extra_experts`, phase 37 for K1, K2, K5 and K6 as `ensemble`, phase
     38 for K1 and K2 as `ensemble_uea`, phase 39's (a), (b) and (c)
     steps (rank 0) and (e) for K1, K2, K5 and K6 as `mesh`, phase 40's
     (a) and (e) as `seq` and (b) and (e) as `expert`, phase 41's (a),
     (c) (rank 0) for K5 and K6 and (b) (rank 0) and (d) for K1, K2, K5
     and K6 as `pipe`; K9, K10a and K10b from phase 42 (a) as `train`, (b)'s
     request for K9 as `flash_serve`, (c) as `flash_long`), then the
     device line.

After each phase a `[time]` line gives its seconds and the seconds since
the start. The K5 and K6 phases (4, 6, 8, 12), the serving phases (20-22)
and phases 23-42 run under a time limit that ends the process (and the
servers it started), so that a kernel that hangs fails the run instead of
holding the card. Times
are CUDA-event times after warm-up (kernels) or host-clock times of work
that ends in a synchronisation (requests, steps). Bounds use the
published H100 SXM peaks: 3.35 TB/s, 67 TFLOP/s FP32, 989 TFLOP/s bf16,
495 TFLOP/s TF32. An f32 attention product is bound by the smaller of the
FP32-FMA time and that of three TF32 products (3xTF32, the f32 kernels'
arithmetic); both figures are printed. It needs no network and imports
nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

PEAK_BYTES = 3.35e12           # B/s
PEAK_FP32 = 67e12              # FLOP/s, CUDA cores
PEAK_BF16 = 989e12             # FLOP/s, tensor cores, dense
PEAK_TF32 = 495e12             # FLOP/s, tensor cores, dense

K1_TOL = 1e-4   # f32, summation order (multiply by 1/L vs divide by L)
K5_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # bf16: output
# rounding and the online softmax's rounding of unnormalised probabilities
SERVE_TOL = 5e-2   # bf16 logits, card vs CPU plain path
REPEATS = 3        # requests of each size; the median time is reported
K2_TOL = 1e-4      # x max|want|: f32 sums of up to 64 * 803 terms, and the
# 1/L applied once at the end, in another order than the plain loop's
K6_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # x max|want|; bf16:
# outputs rounded to bf16, delta from the bf16 output O, and the recomputed
# probabilities from the forward's log-sum-exp
GRAD_TOL = 5e-2    # relative norm error per parameter, bf16, card vs CPU
RATE = 0.1         # attention dropout of the dropout checks
WARMUP, STEPS = 3, 10   # training steps: warm-up, then timed
FUSED_STEPS = 5         # timed steps of the fused flagship (after WARMUP)
LONG_WARMUP, LONG_STEPS = 2, 5   # EigenWorms-shaped training steps
LONG_BH, LONG_T, LONG_DK = 64, 17984, 64   # its attention: 8 rows x 8 heads
LONG_HEADS = 2     # heads held against the chunked plain versions


ROOT = os.path.dirname(os.path.abspath(__file__))
CHILDREN = []   # server processes this run started, killed on any exit


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


class time_limit:
    """Ends the process with code 1, and no `ok` line, if the block runs
    past `seconds`: a kernel that hangs blocks this thread inside the
    driver, where no Python exception reaches it."""

    def __init__(self, seconds: float, what: str):
        self.seconds, self.what = seconds, what

    def _expire(self) -> None:
        print(f"chip_smoke FAILED: {self.what} ran past {self.seconds} s",
              file=sys.stderr, flush=True)
        for proc in CHILDREN:
            proc.kill()
        os._exit(1)

    def __enter__(self):
        self.timer = threading.Timer(self.seconds, self._expire)
        self.timer.daemon = True
        self.timer.start()

    def __exit__(self, *exc):
        self.timer.cancel()


def events_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean CUDA-event time of fn() over reps calls, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bound(nbytes: float, flops: float, dtype):
    """(ms, "bytes" or "operations", text) of an attention kernel's work:
    bf16 at the bf16 tensor-core peak; f32 the smaller of the FP32-FMA
    bound and the 3xTF32 one (each product as three TF32 products), the
    text naming it beside the other figure."""
    if dtype == torch.bfloat16:
        ms, by = bound_ms(nbytes, flops, PEAK_BF16)
        return ms, by, f"{by}, bf16"
    fma = bound_ms(nbytes, flops, PEAK_FP32)
    tf32 = bound_ms(nbytes, 3 * flops, PEAK_TF32)
    if tf32[0] <= fma[0]:
        return (*tf32, f"{tf32[1]}, 3xTF32; FP32-FMA {fma[0]:.4f}")
    return (*fma, f"{fma[1]}, FP32-FMA; 3xTF32 {tf32[0]:.4f}")


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    return smi


def kernel_name(mangled: str) -> str:
    """kernel<template arguments> of a mangled entry name, else the name."""
    k = re.search(r"\d((?:attn|shapelet|l1)_[a-z0-9_]+?)I(.*?)EEv", mangled)
    if not k:
        return mangled
    args = re.findall(r"L[ib](\d+)E", k.group(2))
    return f"{k.group(1)}<{', '.join(args) or k.group(2)}>"


def ptxas_entries(log: str) -> list:
    """(kernel<template arguments>, registers, spill stores, spill loads)
    of each entry function in an `nvcc -Xptxas -v` report."""
    rows, name, spill = [], None, ("?", "?")
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = m.groups()
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spill))
            name = None
    return rows


# the bf16 attention kernels, which must run their products on wgmma
WGMMA_KERNELS = ("attn_fwd_bf16", "attn_bwd_dq_bf16", "attn_bwd_dkv_bf16",
                 "attn_flash_fwd", "attn_flash_bwd_dkv", "attn_flash_bwd_dq")
WGMMA_SOURCES = ("attention_fwd", "attention_bwd", "flash_fwd", "flash_bwd")


def sass_counts(lib: str) -> dict:
    """{kernel<template arguments>: (HGMMA, HMMA)}: the warpgroup (wgmma)
    and warp-level (mma.sync) tensor-core instructions of each function in
    a built library, from `cuobjdump -sass`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            counts[name] = [0, 0]
        elif name is not None:
            op = re.search(r"\b(HGMMA|HMMA)\.", line)
            if op:
                counts[name][op.group(1) == "HMMA"] += 1
    return {k: tuple(v) for k, v in counts.items()}


# SASS opcodes by the pipe that executes them on Hopper: the FP32 pipe (128
# lanes an SM) and the ALU pipe (64 lanes an SM: compares, selects, min/max,
# integer logic), and shared-memory loads
SASS_FP32 = ("FADD", "FFMA", "FMUL")
SASS_ALU = ("FSET", "FSETP", "FSEL", "FMNMX", "ISETP", "IADD3", "LOP3",
            "SHF", "SEL", "IMNMX", "LEA", "PLOP3", "IABS", "FCHK")


def sass_inner_loops(lib: str) -> dict:
    """{kernel<template arguments>: (FP32, ALU, LDS, all)}: the instructions
    of each function's busiest innermost loop (the range from a backward
    branch's target to the branch that holds no other loop, the one with
    the most FP32 instructions), from `cuobjdump -sass`. Per tap, K1 needs
    2 FP32 and K2 1 FP32 and 1 ALU instruction; the rest of the loop is its
    overhead."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            funcs[name] = []
            continue
        ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z0-9]+)(?:\.[A-Z0-9_.]+)?\s*([^;]*);", line)
        if ins and name is not None:
            funcs[name].append((int(ins.group(1), 16), ins.group(2),
                                ins.group(3)))
    result = {}
    for name, body in funcs.items():
        loops = []
        for addr, op, arg in body:
            t = re.match(r"\s*(0x[0-9a-f]+)", arg) if op == "BRA" else None
            if t and int(t.group(1), 16) <= addr:
                loops.append((int(t.group(1), 16), addr))
        inner = [(a, b) for a, b in loops
                 if not any(a <= c and d <= b and (c, d) != (a, b)
                            for c, d in loops)]
        best = None
        for a, b in inner:
            ops = [op for addr, op, _ in body if a <= addr <= b]
            row = (sum(op in SASS_FP32 for op in ops),
                   sum(op in SASS_ALU for op in ops),
                   sum(op == "LDS" for op in ops), len(ops))
            if best is None or row[0] > best[0]:
                best = row
        if best is not None:
            result[name] = best
    return result


def phase_build() -> None:
    from sie_tpu_torch.ops import build
    t0 = time.perf_counter()
    build.build()
    print(f"[build] {time.perf_counter() - t0:.3f} s for "
          f"{', '.join(build.SIGNATURES)}")
    sass = {}
    for src in WGMMA_SOURCES:
        sass.update(sass_counts(build._lib_path(src)))
    for src, log in build.PTXAS_LOG.items():
        for name, regs, stores, loads in ptxas_entries(log):
            ops = sass.get(name)
            extra = "" if ops is None else f"; SASS HGMMA {ops[0]}, HMMA {ops[1]}"
            print(f"[build] {src}: {name}: {regs} registers, spill stores "
                  f"{stores} B, loads {loads} B{extra}")
    for src in WGMMA_SOURCES:   # e.g. serialized wgmma
        for line in build.PTXAS_LOG.get(src, "").splitlines():
            if "arning" in line or "Performance Loss" in line:
                print(f"[build] {src}: ptxas: {line.strip()}")
    # the shapelet kernels' flagship instantiations (n = 10: K1 and K3 take
    # 10 shapelet rows a block, K2 and K4 5): FP32, ALU and shared-load
    # instructions of the inner loop
    for src in [n for n in build.SIGNATURES if n.startswith("shapelet")]:
        for name, (fp32, alu, lds, total) in sorted(
                sass_inner_loops(build._lib_path(src)).items()):
            if re.match(r"l1_fwd_\w+<10\b|l1_bwd_\w*partial<5\b", name):
                print(f"[build] {src}: {name}: inner loop FP32 {fp32}, ALU "
                      f"{alu}, LDS {lds}, all {total} instructions")
    wg = {k: v for k, v in sass.items() if k.startswith(WGMMA_KERNELS)}
    # K5/K6: 2 widths x 2 loaders (TMA, cp.async) x (4 forward, 2 + 2
    # backward); K9 (with and without the log-sum-exp) and K10b, K10a
    # (flash_bwd.cu): 3 widths x 2, and K10a's halved tiles at dk 64
    if len(wg) != 45:
        fail(f"bf16 attention instantiations in the SASS: {sorted(wg)}")
    off = {k: v for k, v in wg.items() if v[0] == 0 or v[1] != 0}
    if off:
        fail(f"bf16 attention kernels without wgmma, or with mma.sync: {off}")
    print(f"[build] bf16 attention: all {len(wg)} instantiations run wgmma "
          f"(HGMMA {min(v[0] for v in wg.values())}-"
          f"{max(v[0] for v in wg.values())} each), no HMMA")


def issue_floor(flops: float) -> str:
    """The issue-slot floor of a shapelet kernel doing `flops` = 2 x taps.
    The table's FP32 peak counts an FMA as two operations, but a tap is two
    instructions (K1: subtract, add of |.|; K2-K4: a compare, which the
    64-lane ALU pipe takes in two of its cycles, and an FMA), and an SM
    issues one instruction a clock on each of its four schedulers (128
    lanes): taps x 2 / (SMs x 128 x clock), twice the operations bound."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ms = 1e3 * flops / (sms * 128 * mhz * 1e6)
    return (f"issue-slot floor {ms:.4f} ms ({sms} SMs x 128 lanes at "
            f"{mhz:.0f} MHz max SM clock, two instructions a tap)")


def phase_k1() -> dict:
    from sie_tpu_torch.config import Config
    from sie_tpu_torch.models.sbm import bank_lengths
    from sie_tpu_torch.ops.shapelet_l1 import (l1_sliding_distance,
                                               l1_sliding_distance_plain)
    b, c, t, n = 64, 122, 845, 10
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((b, c, t), generator=g, device="cuda")
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               bytes=0.0, flops=0.0)
    err = 0.0
    for l in bank_lengths(Config()):
        s = torch.randn((n, c, l), generator=g, device="cuda")
        w = t - l + 1
        for metric in ("euclidean", "sqeuclidean"):
            got = l1_sliding_distance(x, s, metric)
            want = l1_sliding_distance_plain(x, s, metric)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            err = max(err, e)
            if not e <= K1_TOL:
                fail(f"K1 {metric} L={l}: max abs err {e} > {K1_TOL}")
            del got, want
        # times: the euclidean metric, which the flagship serves
        ms = events_ms(lambda: l1_sliding_distance(x, s), reps=10)
        plain_ms = events_ms(lambda: l1_sliding_distance_plain(x, s), reps=1)
        xu = x.unfold(-1, l, 1).transpose(0, 1).reshape(c, b * w, l)
        sc = s.transpose(0, 1).contiguous()                      # (C, n, L)
        lib_ms = events_ms(lambda: torch.cdist(xu, sc, p=1), reps=2)
        lib = torch.cdist(xu, sc, p=1).view(c, b, w, n).permute(1, 3, 0, 2) / l
        e = float((lib - l1_sliding_distance(x, s)).abs().max())
        del xu, lib
        nbytes = 4 * (b * c * t + n * c * l + b * n * c * w)
        flops = 2 * b * n * c * w * l
        bms, _ = bound_ms(nbytes, flops, PEAK_FP32)
        print(f"[K1] L={l} W={w}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms,"
              f" cdist {lib_ms:.3f} ms (|diff| {e:.2e}), bound {bms:.4f} ms")
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                     ("bound_ms", bms), ("bytes", nbytes), ("flops", flops)):
            tot[k] += v
    _, by = bound_ms(tot["bytes"], tot["flops"], PEAK_FP32)
    print(f"[K1] six banks: kernel {tot['ms']:.4f} ms, plain "
          f"{tot['plain_ms']:.3f} ms, cdist {tot['library_ms']:.3f} ms, bound "
          f"{tot['bound_ms']:.4f} ms ({by}), max abs err {err:.3e}")
    print(f"[K1] six banks: {issue_floor(tot['flops'])}; its "
          f"{tot['bytes'] / 1e9:.3f} GB in and out take "
          f"{1e3 * tot['bytes'] / PEAK_BYTES:.4f} ms at 3.35 TB/s")
    return {"name": "K1 shapelet_l1_fwd", "route": "cuda",
            "source": "sie_tpu_torch/csrc/shapelet_l1_fwd.cu",
            "replaces": "sie_tpu/ops/pallas/shapelet_pallas.py:110",
            "max_abs_err": err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": by,
            "library_ms": tot["library_ms"]}


def phase_k5() -> dict:
    import torch.nn.functional as F
    from sie_tpu_torch.ops.attention import attention_plain, fused_attention
    g = torch.Generator(device="cuda").manual_seed(2)
    main = None
    err_main = 0.0
    for bh, t, dk, dtype in ((512, 845, 64, torch.bfloat16),
                             (512, 845, 64, torch.float32),
                             (64, 300, 64, torch.bfloat16),
                             (64, 300, 64, torch.float32)):
        q, k, v = (torch.randn((bh, t, dk), generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
        scale = 1.0 / dk ** 0.5
        got = fused_attention(q, k, v, scale)
        want = attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        e = float((got.float() - want.float()).abs().max())
        tag = f"BH={bh} T={t} dk={dk} {str(dtype)[6:]}"
        if not e <= K5_TOL[dtype]:
            fail(f"K5 {tag}: max abs err {e} > {K5_TOL[dtype]}")
        ms = events_ms(lambda: fused_attention(q, k, v, scale), reps=20)
        plain_ms = events_ms(lambda: attention_plain(q, k, v, scale), reps=3)
        q4, k4, v4 = (z.view(1, bh, t, dk) for z in (q, k, v))  # (N, H, T, dk)
        lib_ms = events_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, scale=scale), reps=20)
        nbytes = 4 * bh * t * dk * q.element_size()
        flops = 4 * bh * t * t * dk
        bms, by, btxt = attention_bound(nbytes, flops, dtype)
        print(f"[K5] {tag}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, sdpa "
              f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({btxt}), max abs err "
              f"{e:.3e}")
        if main is None:   # the flagship serving shape
            main = {"name": "K5 attention_fwd", "route": "cuda",
                    "source": "sie_tpu_torch/csrc/attention_fwd.cu",
                    "replaces": "sie_tpu/ops/pallas/attention_pallas.py:97",
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                    "bound_by": by, "library_ms": lib_ms}
        if dtype == torch.bfloat16:
            err_main = max(err_main, e)
        del q, k, v, q4, k4, v4, got, want
    main["max_abs_err"] = err_main
    return main


def flagship_config():
    from sie_tpu_torch.config import Config
    # bench.py's flagship: CHISCO shapes, 6 banks of 10 shapelets,
    # Transformer expert d_model 512 / 8 heads / 2 layers / d_ff 2048, bf16
    return Config(model="InterpGN", dnn_type="Transformer", seq_len=845,
                  enc_in=122, num_class=3, num_shapelet=10, d_model=512,
                  d_ff=2048, n_heads=8, e_layers=2, dropout=0.0, amp=True,
                  seed=0)


KERNEL_IDS = ("K1", "K2", "K3", "K4", "K5", "K6", "K9", "K10a", "K10b")


class Counts:
    """The kernels' launch counters: zeroed, read, and checked. K7 is K5's
    wrapper and K8a/K8b are K6's: they count under K5 and K6."""

    def __init__(self):
        from sie_tpu_torch.ops.attention import attention_bwd, fused_attention
        from sie_tpu_torch.ops.flash import (flash_attention,
                                             flash_attention_bwd_dkv,
                                             flash_attention_bwd_dq)
        from sie_tpu_torch.ops.shapelet_l1 import (
            l1_sliding_distance, l1_sliding_distance_bwd,
            l1_sliding_distance_grouped, l1_sliding_distance_grouped_bwd)
        self.fns = {"K1": l1_sliding_distance, "K2": l1_sliding_distance_bwd,
                    "K3": l1_sliding_distance_grouped,
                    "K4": l1_sliding_distance_grouped_bwd,
                    "K5": fused_attention, "K6": attention_bwd,
                    "K9": flash_attention, "K10a": flash_attention_bwd_dq,
                    "K10b": flash_attention_bwd_dkv}

    def zero(self) -> None:
        for fn in self.fns.values():
            fn.launches = 0

    def read(self) -> dict:
        return {k: fn.launches for k, fn in self.fns.items()}

    def since(self, before: dict) -> dict:
        return {k: v - before[k] for k, v in self.read().items()}

    @staticmethod
    def full(want: dict, times: int = 1) -> dict:
        """`want` scaled by `times`, with 0 for every kernel it omits."""
        return {k: want.get(k, 0) * times for k in KERNEL_IDS}


SERVE_SIZES = (1, 5, 64, 150)


def serve_requests(pred, want: dict, tag: str):
    """Requests of SERVE_SIZES rows through the predictor `pred` (max_batch
    64) on the card, each checked for `want` launches per chunk of
    max_batch rows and none of the other kernels; returns the outputs by
    size, the inputs, the median ms by size and the launches over the
    run."""
    cfg = pred.cfg
    counts = Counts()
    rng = np.random.default_rng(0)
    xs = {b: rng.normal(size=(b, cfg.seq_len, cfg.enc_in)).astype(np.float32)
          for b in SERVE_SIZES}
    for b in SERVE_SIZES:   # warm-up: every bucket the run below hits
        pred.predict(xs[b][: min(b, 64)])
    torch.cuda.synchronize()
    counts.zero()
    outs, served_ms = {}, {}
    for b in SERVE_SIZES:
        times = []
        for _ in range(REPEATS):
            c0 = counts.read()
            t0 = time.perf_counter()
            out = pred.predict(xs[b])
            times.append(1e3 * (time.perf_counter() - t0))
            chunks = -(-b // pred.max_batch)
            got, expect = counts.since(c0), Counts.full(want, chunks)
            if got != expect:
                fail(f"{tag} request of {b}: launches {got}, want {expect}")
        served_ms[b] = float(np.median(times))
        outs[b] = out
    launches = counts.read()
    print(f"[{tag}] launches over the run: {launches}")
    for b, out in outs.items():
        if out.logits.shape != (b, cfg.num_class) or \
                out.p.shape != (b, 7320) or out.eta.shape != (b, 1):
            fail(f"{tag} request of {b}: shapes {out.logits.shape}, "
                 f"{out.p.shape}")
        for name in ("logits", "probs", "eta", "p", "d"):
            if not np.isfinite(getattr(out, name)).all():
                fail(f"{tag} request of {b}: non-finite {name}")
        if not (out.classes == out.logits.argmax(-1)).all():
            fail(f"{tag} request of {b}: classes != argmax(logits)")
    print(f"[{tag}] ms per request (median of {REPEATS}): " + ", ".join(
        f"{b} rows {served_ms[b]:.3f}" for b in SERVE_SIZES))
    return outs, xs, served_ms, launches


def serve_module(cfg, model, want: dict, tag: str):
    """`serve_requests` through `Predictor.from_module(cfg, model)`."""
    from sie_tpu_torch.serve import Predictor
    return serve_requests(Predictor.from_module(cfg, model, device="cuda",
                                                max_batch=64), want, tag)


def phase_serve() -> dict:
    from sie_tpu_torch.models.registry import build_model
    from sie_tpu_torch.serve import Predictor
    cfg = flagship_config()
    model = build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    outs, xs, _, launches = serve_module(cfg, model, {"K1": 6, "K5": 2},
                                         "serve")
    cpu = Predictor.from_module(cfg, copy.deepcopy(model).cpu(),
                                device="cpu", max_batch=64)
    ref = cpu.predict(xs[5][:2])
    got = outs[5].logits[:2]
    e = float(np.abs(got - ref.logits).max())
    print(f"[serve] card vs CPU plain path, 2 rows: max |dlogits| {e:.3e}; "
          f"classes {got.argmax(-1).tolist()} vs {ref.classes.tolist()}")
    if not e <= SERVE_TOL or not (got.argmax(-1) == ref.classes).all():
        fail(f"served logits differ from the CPU plain path: {e}")
    return outs, launches


def phase_k5_dropout() -> None:
    """K5 at rate 0.1 against its plain version, and its log-sum-exp
    output; times at rate 0.1 and rate 0."""
    from sie_tpu_torch.ops.attention import (attention_fwd, attention_plain,
                                             fused_attention)
    g = torch.Generator(device="cuda").manual_seed(5)
    bh, t, dk = 512, 845, 64
    scale, seed = 1.0 / dk ** 0.5, 1234
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn((bh, t, dk), generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
        got, lse = attention_fwd(q, k, v, scale, RATE, seed, want_lse=True)
        want = attention_plain(q, k, v, scale, RATE, seed)
        torch.cuda.synchronize()
        e = float((got.float() - want.float()).abs().max())
        tag = f"BH={bh} T={t} dk={dk} {str(dtype)[6:]} rate {RATE}"
        if not e <= K5_TOL[dtype]:
            fail(f"K5 {tag}: max abs err {e} > {K5_TOL[dtype]}")
        s = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if dtype == torch.bfloat16:
            s = s.to(torch.bfloat16).float()
        e_lse = float((lse - torch.logsumexp(s * scale, dim=-1)).abs().max())
        del s
        if not e_lse <= 1e-3:
            fail(f"K5 {tag}: log-sum-exp max abs err {e_lse} > 1e-3")
        ms = events_ms(lambda: fused_attention(q, k, v, scale, RATE, seed),
                       reps=20)
        ms0 = events_ms(lambda: fused_attention(q, k, v, scale), reps=20)
        print(f"[K5] {tag}: kernel {ms:.4f} ms (rate 0: {ms0:.4f} ms), max "
              f"abs err {e:.3e}, log-sum-exp err {e_lse:.3e}")
        del q, k, v, got, want, lse


def phase_k2() -> dict:
    from sie_tpu_torch.config import Config
    from sie_tpu_torch.models.sbm import bank_lengths
    from sie_tpu_torch.ops.shapelet_l1 import (l1_sliding_distance_bwd,
                                               l1_sliding_distance_bwd_plain)
    b, c, t, n = 64, 122, 845, 10
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((b, c, t), generator=gen, device="cuda")
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0.0, flops=0.0)
    err, rel = 0.0, 0.0   # max abs error, and relative to max|want|
    for l in bank_lengths(Config()):
        w = t - l + 1
        s = torch.randn((n, c, l), generator=gen, device="cuda")
        g = torch.randn((b, n, c, w), generator=gen, device="cuda")
        for metric in ("euclidean", "sqeuclidean"):
            got = l1_sliding_distance_bwd(x, s, g, metric)
            want = l1_sliding_distance_bwd_plain(x, s, g, metric)
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            e = float((got - want).abs().max())
            err, rel = max(err, e), max(rel, e / scale)
            if not e <= K2_TOL * scale:
                fail(f"K2 {metric} L={l}: max abs err {e} > {K2_TOL} x "
                     f"{scale}")
            if not torch.equal(got, l1_sliding_distance_bwd(x, s, g, metric)):
                fail(f"K2 {metric} L={l}: two runs differ")
        ms = events_ms(lambda: l1_sliding_distance_bwd(x, s, g), reps=10)
        plain_ms = events_ms(lambda: l1_sliding_distance_bwd_plain(x, s, g),
                             reps=1)
        nbytes = 4 * (b * c * t + 2 * n * c * l + b * n * c * w)
        flops = 2 * b * n * c * w * l
        bms, _ = bound_ms(nbytes, flops, PEAK_FP32)
        print(f"[K2] L={l} W={w}: kernel {ms:.4f} ms, plain {plain_ms:.3f} "
              f"ms, bound {bms:.4f} ms")
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", bms), ("bytes", nbytes),
                         ("flops", flops)):
            tot[key] += val
        del s, g
    _, by = bound_ms(tot["bytes"], tot["flops"], PEAK_FP32)
    del x
    lib = k2_library_ms()
    print(f"[K2] six banks: kernel {tot['ms']:.4f} ms, plain "
          f"{tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms ({by}), "
          f"max abs err {err:.3e} ({rel:.3e} x max|want|); library "
          f"{'(not all banks ran)' if lib is None else f'{lib:.4f} ms'}")
    print(f"[K2] six banks: {issue_floor(tot['flops'])}")
    return {"name": "K2 shapelet_l1_bwd", "route": "cuda",
            "source": "sie_tpu_torch/csrc/shapelet_l1_bwd.cu",
            "replaces": "sie_tpu/ops/pallas/shapelet_pallas.py:162",
            "max_abs_err": err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": by, "library_ms": lib}


K2_LIB_FLAG = "--k2-library"   # argument of the child process below
K2_LIB_BUDGET = 300            # s, all child processes together


def k2_library_rows(b: int, c: int, n: int, t: int, l: int) -> int:
    """Batch rows per torch.cdist(p=1) call to try first: the largest power
    of two at which the (C, rows * W, n, L) elements of its backward stay
    below 2^31 (a 32-bit index), at most b."""
    rows = 1
    while rows * 2 <= b and c * rows * 2 * (t - l + 1) * n * l < 2 ** 31:
        rows *= 2
    return rows


def k2_library_child(first: int, rows_first: int) -> None:
    """The child process of `k2_library_ms`: times the one PyTorch call for
    K2's function, the bank gradient through torch.cdist(p=1) (backward
    only, as the SDPA backward is timed), on banks first, first + 1, ... at
    phase_k2's shapes. The batch is split into calls of `rows` batch rows
    (rows_first at the first bank, `k2_library_rows` after it) and their
    times summed; one flushed line a bank with the split, the summed time
    and the max abs difference of the summed gradient from K2. A fault ends
    the process at its bank."""
    from sie_tpu_torch.config import Config
    from sie_tpu_torch.models.sbm import bank_lengths
    from sie_tpu_torch.ops.shapelet_l1 import l1_sliding_distance_bwd
    b, c, t, n = 64, 122, 845, 10
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((b, c, t), generator=gen, device="cuda")
    for i, l in enumerate(bank_lengths(Config())):
        w = t - l + 1
        s = torch.randn((n, c, l), generator=gen, device="cuda")
        g = torch.randn((b, n, c, w), generator=gen, device="cuda")
        if i < first:
            continue
        rows = rows_first if i == first else k2_library_rows(b, c, n, t, l)
        sg = s.detach().requires_grad_()
        calls = []
        for b0 in range(0, b, rows):
            xb = x[b0:b0 + rows]
            r = xb.shape[0]
            xu = xb.unfold(-1, l, 1).transpose(0, 1).reshape(c, r * w, l)
            d = torch.cdist(xu, sg.transpose(0, 1), p=1)      # (C, r*W, n)
            gd = (g[b0:b0 + rows] / l).permute(2, 0, 3, 1).reshape(c, r * w,
                                                                   n)
            calls.append((d, gd))

        def run():
            return sum(torch.autograd.grad(d, sg, gd, retain_graph=True)[0]
                       for d, gd in calls)
        ms = events_ms(run, reps=2)
        e = float((run() - l1_sliding_distance_bwd(x, s, g)).abs().max())
        print(f"{K2_LIB_FLAG} {i} {l} {rows} {ms} {e}", flush=True)
        del calls, run


def k2_library_ms():
    """K2's library time summed over the six banks, each bank's batch split
    into calls of fewer rows until they run: a child process times banks
    from a first one on (a fault there cannot reach this process's CUDA
    context); a child that faults at a bank is followed by one that splits
    that bank's batch in half again, down to single rows, within
    K2_LIB_BUDGET seconds for all. None unless every bank ran; every bank's
    split and time, or its fault, is printed."""
    from sie_tpu_torch.config import Config
    from sie_tpu_torch.models.sbm import bank_lengths
    lengths = bank_lengths(Config())
    torch.cuda.empty_cache()   # the children need the card's memory
    times, first = {}, 0
    rows = k2_library_rows(64, 122, 10, 845, lengths[0])
    deadline = time.monotonic() + K2_LIB_BUDGET
    while first < len(lengths):
        cmd = [sys.executable, os.path.abspath(__file__), K2_LIB_FLAG,
               str(first), str(rows)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=max(1.0, deadline - time.monotonic()))
            errs = [ln for ln in r.stderr.splitlines() if "Error:" in ln]
            out, why = r.stdout, (errs or [f"exit code {r.returncode}"])[0]
        except subprocess.TimeoutExpired as exc:
            out = exc.stdout or ""
            out = out.decode() if isinstance(out, bytes) else out
            why = f"the {K2_LIB_BUDGET} s for all banks ran out"
        for line in out.splitlines():
            if line.startswith(K2_LIB_FLAG):
                _, i, l, rr, ms, e = line.split()
                times[int(i)] = float(ms)
                print(f"[K2] library, bank L={l}: cdist(p=1) backward in "
                      f"calls of {rr} of 64 batch rows, summed "
                      f"{float(ms):.4f} ms, max |diff| from K2 "
                      f"{float(e):.3e}")
        done = max([first - 1, *times]) + 1
        if done >= len(lengths) or time.monotonic() >= deadline:
            break
        # the child stopped at bank `done`, which it ran in calls of `tried`
        tried = rows if done == first else k2_library_rows(
            64, 122, 10, 845, lengths[done])
        first = done
        print(f"[K2] library, bank L={lengths[first]}: calls of {tried} "
              f"batch rows fault: {why[:160]}")
        if tried > 1:
            rows = tried // 2
        else:
            first += 1
            if first < len(lengths):
                rows = k2_library_rows(64, 122, 10, 845, lengths[first])
    return sum(times.values()) if len(times) == len(lengths) else None


def phase_k6() -> dict:
    import torch.nn.functional as F
    from sie_tpu_torch.ops.attention import (attention_bwd,
                                             attention_bwd_plain,
                                             attention_fwd)
    gen = torch.Generator(device="cuda").manual_seed(6)
    main, err_main = None, 0.0   # max abs error of the bf16 cases
    for bh, t, dk, dtype, rate in ((512, 845, 64, torch.bfloat16, 0.0),
                                   (512, 845, 64, torch.bfloat16, RATE),
                                   (512, 845, 64, torch.float32, 0.0),
                                   (512, 845, 64, torch.float32, RATE),
                                   (64, 300, 64, torch.bfloat16, RATE),
                                   (64, 300, 64, torch.float32, 0.0)):
        q, k, v, do = (torch.randn((bh, t, dk), generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        scale, seed = 1.0 / dk ** 0.5, 4321
        o, lse = attention_fwd(q, k, v, scale, rate, seed, want_lse=True)
        run = lambda: attention_bwd(q, k, v, o, do, lse, scale, rate, seed)
        got = run()
        want = attention_bwd_plain(q, k, v, do, scale, rate, seed)
        torch.cuda.synchronize()
        tag = f"BH={bh} T={t} dk={dk} {str(dtype)[6:]} rate {rate}"
        errs, abs_errs = [], []
        for name, a, w in zip("qkv", got, want):
            scl = float(w.float().abs().max())
            e = float((a.float() - w.float()).abs().max())
            errs.append(e / scl)
            abs_errs.append(e)
            if not e <= K6_TOL[dtype] * scl:
                fail(f"K6 {tag} d{name}: max abs err {e} > {K6_TOL[dtype]} x "
                     f"{scl}")
        if not all(torch.equal(a, b) for a, b in zip(got, run())):
            fail(f"K6 {tag}: two runs differ")
        del got, want
        ms = events_ms(run, reps=10)
        plain_ms = events_ms(lambda: attention_bwd_plain(
            q, k, v, do, scale, rate, seed), reps=2)
        lib_ms = None
        if rate == 0.0:
            q4, k4, v4 = (z.view(1, bh, t, dk).detach().requires_grad_()
                          for z in (q, k, v))
            out4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
            lib_ms = events_ms(lambda: torch.autograd.grad(
                out4, (q4, k4, v4), do.view(1, bh, t, dk), retain_graph=True),
                reps=10)
            del q4, k4, v4, out4
        esz = q.element_size()
        nbytes = 8 * bh * t * dk * esz + 4 * bh * t
        flops = 10 * bh * t * t * dk
        bms, by, btxt = attention_bound(nbytes, flops, dtype)
        print(f"[K6] {tag}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"sdpa backward {lib_ms} ms, bound {bms:.4f} ms ({btxt}), max "
              f"err dq/dk/dv {errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} x "
              f"max|want|")
        if dtype == torch.bfloat16:
            err_main = max(err_main, max(abs_errs))
        if main is None:   # the flagship training shape, bf16, rate 0
            main = {"name": "K6 attention_bwd", "route": "cuda",
                    "source": "sie_tpu_torch/csrc/attention_bwd.cu",
                    "replaces": "sie_tpu/ops/pallas/attention_pallas.py:111",
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                    "bound_by": by, "library_ms": lib_ms}
        del q, k, v, do, o, lse
    main["max_abs_err"] = err_main
    return main


def train_config(**kw):
    # the flagship with bench.py's training settings: lr 5e-3, beta 1
    return flagship_config().replace(batch_size=64, lr=5e-3, **kw)


def random_rows(cfg, n: int):
    """n rows of random inputs and labels from np.random.default_rng(0),
    shaped like a dataset split for `Trainer.device_data`."""
    rng = np.random.default_rng(0)
    return type("Rows", (), dict(
        x=rng.normal(size=(n, cfg.seq_len, cfg.enc_in)).astype(np.float32),
        y=rng.integers(0, cfg.num_class, n).astype(np.int32),
        padding_mask=np.ones((n, cfg.seq_len), np.float32)))()


WATCH = ("sbm.shapelets_0", "sbm.output_layer.weight",
         "deep_model.encoder.layers.0.attention.query.weight",
         "deep_model.projection.weight")


def train_steps(cfg, ds, want: dict, warmup: int, steps: int, tag: str,
                watch: tuple = WATCH):
    """`warmup` then `steps` timed `Trainer.train_step_indexed` steps of
    cfg.batch_size rows gathered on the card from `ds` (held there), each
    checked for `want` launches a step and none of the other kernels, a
    finite loss and moved weights. The counts are zeroed just before the
    timed steps and read just after. Returns (trainer, device data, the
    index schedule, step ms, losses, launches over the timed steps)."""
    from sie_tpu_torch.train.trainer import Trainer
    counts = Counts()
    n, b = len(ds.y), cfg.batch_size
    trainer = Trainer(cfg, steps_per_epoch=max(1, n // b), device="cuda",
                      generator=torch.Generator().manual_seed(0))
    dev = trainer.device_data("train", ds)
    w = np.ones((b,), np.float32)
    rng = np.random.default_rng(1)
    sched = [rng.integers(0, n, b) for _ in range(warmup + steps)]
    params = dict(trainer.model.named_parameters())
    expect = Counts.full(want)

    def step(i):
        before = {k: params[k].detach().clone() for k in watch}
        c0 = counts.read()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.train_step_indexed(dev, sched[i], w, 1.0)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        got = counts.since(c0)
        if got != expect:
            fail(f"{tag} step {i}: launches {got}, want {expect}")
        if not np.isfinite(float(loss)):
            fail(f"{tag} step {i}: loss {float(loss)}")
        still = [k for k in watch if torch.equal(before[k], params[k])]
        if still:
            fail(f"{tag} step {i}: parameters did not move: {still}")
        return ms, float(loss)

    for i in range(warmup):
        step(i)
    counts.zero()   # the path's main run: the timed steps
    res = [step(warmup + i) for i in range(steps)]
    launches = counts.read()
    times = [r[0] for r in res]
    step_ms = float(np.median(times))
    print(f"[{tag}] ms per step (B={b}): " + ", ".join(f"{t:.3f}" for t in
                                                      times))
    print(f"[{tag}] median {step_ms:.3f} ms/step, {1e3 * b / step_ms:.1f} "
          f"samples/s; losses {res[0][1]:.4f} .. {res[-1][1]:.4f}; launches "
          f"over {steps} steps {launches}")
    return trainer, dev, sched, times, [r[1] for r in res], launches


def dropout_step(cfg, dev, idx, want: dict, tag: str) -> None:
    """One step at attention and layer dropout RATE: the same kernels, a
    finite loss."""
    from sie_tpu_torch.train.trainer import Trainer
    counts = Counts()
    drop = Trainer(cfg.replace(dropout=RATE), steps_per_epoch=1,
                   device="cuda", generator=torch.Generator().manual_seed(0))
    c0 = counts.read()
    loss, _ = drop.train_step_indexed(dev, idx, np.ones(len(idx), np.float32),
                                      1.0)
    got = counts.since(c0)
    if got != Counts.full(want) or not np.isfinite(float(loss)):
        fail(f"{tag} dropout step: launches {got}, loss {float(loss)}")
    print(f"[{tag}] dropout {RATE}: loss {float(loss):.4f}, launches {got}")


def gradients(cfg, model, device, batch) -> dict:
    """The loss gradient of every parameter of `model` on `batch`, on the
    host, in float32."""
    from sie_tpu_torch.train.trainer import Trainer
    t = Trainer(cfg, 1, model=model, device=device)
    loss, _ = t.loss_fn(t.model, t._device_batch(batch), 1.0, None)
    loss.backward()
    return {k: p.grad.float().cpu() for k, p in t.model.named_parameters()}


def worst_gradient(got: dict, want: dict, what: str):
    """The largest relative norm error of got against want, per parameter;
    fails above GRAD_TOL."""
    worst = ("", 0.0)
    for name, gw in want.items():
        if name.endswith("attention.key.bias"):
            continue   # zero in exact arithmetic: only rounding noise
        e = float((got[name] - gw).norm() / gw.norm())
        worst = max(worst, (name, e), key=lambda z: z[1])
        if not e <= GRAD_TOL:
            fail(f"{what} gradient of {name}: relative error {e}")
    return worst


def phase_train() -> dict:
    from sie_tpu_torch.models.registry import build_model
    from sie_tpu_torch.train.trainer import weighted_ce
    cfg = train_config()
    ds = random_rows(cfg, 256)
    b = cfg.batch_size
    want = {"K1": 6, "K2": 6, "K5": 2, "K6": 2}
    trainer, dev, sched, times, _, launches = train_steps(
        cfg, ds, want, WARMUP, STEPS, "train")
    step_ms = float(np.median(times))

    # decomposition (bench.py's): fwd+bwd of the full model, of the SBM
    # branch alone and of the Transformer expert alone, every gradient
    # leaf consumed; the optimizer's share is the step minus the full one
    model = trainer.model
    idx = torch.as_tensor(sched[0], device="cuda")
    x, y, mask = (leaf[idx] for leaf in dev)
    wt = torch.ones(b, device="cuda")
    plist = [p for p in model.parameters()]

    def fwdbwd(which):
        if which == "sbm":
            out, info = model.sbm(x, mask, generator=trainer.generator)
            loss = weighted_ce(out, y, wt) + info.loss.mean()
        elif which == "dnn":
            loss = weighted_ce(model.deep_model(x, mask, trainer.generator),
                               y, wt)
        else:
            out, info = model(x, mask, generator=trainer.generator)
            loss = weighted_ce(out, y, wt) + info.loss.mean()
        grads = torch.autograd.grad(loss, plist, allow_unused=True)
        return sum(g.float().sum() for g in grads if g is not None)

    split = {}
    for which in ("full", "sbm", "dnn"):
        fwdbwd(which)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            total = fwdbwd(which)
        float(total)
        split[which] = 1e3 * (time.perf_counter() - t0) / STEPS
    print(f"[train] fwd+bwd ms: full {split['full']:.3f}, sbm "
          f"{split['sbm']:.3f}, dnn {split['dnn']:.3f}; optimizer_ms "
          f"{step_ms - split['full']:.3f} (step minus full fwd+bwd)")
    dropout_step(cfg, dev, sched[0], want, "train")

    # card against the CPU plain path: gradients at the same weights, 2 rows
    fresh = build_model(cfg, "cuda", torch.Generator().manual_seed(0)).train()
    cpu = copy.deepcopy(fresh).cpu()
    batch = (ds.x[:2], ds.y[:2], ds.padding_mask[:2], np.ones(2, np.float32))
    worst = worst_gradient(gradients(cfg, fresh, "cuda", batch),
                           gradients(cfg, cpu, "cpu", batch), "card vs CPU")
    print(f"[train] card vs CPU plain path, 2 rows: worst relative gradient "
          f"error {worst[1]:.3e} ({worst[0]})")
    return launches


def phase_k3_k4() -> tuple:
    """K3 and K4 on the six flagship banks against six K1 and six K2
    launches (bit for bit) and against their plain versions; times."""
    from sie_tpu_torch.config import Config
    from sie_tpu_torch.models.sbm import bank_lengths
    from sie_tpu_torch.ops.shapelet_l1 import (
        l1_sliding_distance, l1_sliding_distance_bwd,
        l1_sliding_distance_grouped, l1_sliding_distance_grouped_bwd,
        l1_sliding_distance_grouped_bwd_plain,
        l1_sliding_distance_grouped_plain)
    b, c, t, n = 64, 122, 845, 10
    gen = torch.Generator(device="cuda").manual_seed(7)
    lengths = bank_lengths(Config())
    x = torch.randn((b, c, t), generator=gen, device="cuda")
    banks = [torch.randn((n, c, l), generator=gen, device="cuda")
             for l in lengths]
    gs = [torch.randn((b, n, c, t - l + 1), generator=gen, device="cuda")
          for l in lengths]

    outs = l1_sliding_distance_grouped(x, banks)
    per_bank = [l1_sliding_distance(x, s) for s in banks]
    want = l1_sliding_distance_grouped_plain(x, banks)
    torch.cuda.synchronize()
    for l, o, k1 in zip(lengths, outs, per_bank):
        if not torch.equal(o, k1):
            fail(f"K3 L={l}: differs from K1 by "
                 f"{float((o - k1).abs().max())}")
    err3 = max(float((o - w).abs().max()) for o, w in zip(outs, want))
    if not err3 <= K1_TOL:
        fail(f"K3: max abs err {err3} against the plain version > {K1_TOL}")
    del outs, per_bank, want

    grads = l1_sliding_distance_grouped_bwd(x, banks, gs)
    per_bank = [l1_sliding_distance_bwd(x, s, g) for s, g in zip(banks, gs)]
    want = l1_sliding_distance_grouped_bwd_plain(x, banks, gs)
    again = l1_sliding_distance_grouped_bwd(x, banks, gs)
    torch.cuda.synchronize()
    err4, rel4 = 0.0, 0.0
    for l, gr, k2, w, a in zip(lengths, grads, per_bank, want, again):
        if not torch.equal(gr, k2):
            fail(f"K4 L={l}: differs from K2 by "
                 f"{float((gr - k2).abs().max())}")
        if not torch.equal(gr, a):
            fail(f"K4 L={l}: two runs differ")
        scale = float(w.abs().max())
        e = float((gr - w).abs().max())
        err4, rel4 = max(err4, e), max(rel4, e / scale)
        if not e <= K2_TOL * scale:
            fail(f"K4 L={l}: max abs err {e} > {K2_TOL} x {scale}")
    del grads, per_bank, want, again

    def k1_all():
        for s in banks:
            l1_sliding_distance(x, s)

    def k2_all():
        for s, g in zip(banks, gs):
            l1_sliding_distance_bwd(x, s, g)

    # in turns: grouped, per bank, per bank, grouped
    ms3a = events_ms(lambda: l1_sliding_distance_grouped(x, banks), reps=10)
    ms1a = events_ms(k1_all, reps=10)
    ms1b = events_ms(k1_all, reps=10)
    ms3b = events_ms(lambda: l1_sliding_distance_grouped(x, banks), reps=10)
    ms4a = events_ms(lambda: l1_sliding_distance_grouped_bwd(x, banks, gs),
                     reps=10)
    ms2a = events_ms(k2_all, reps=10)
    ms2b = events_ms(k2_all, reps=10)
    ms4b = events_ms(lambda: l1_sliding_distance_grouped_bwd(x, banks, gs),
                     reps=10)
    plain3 = events_ms(lambda: l1_sliding_distance_grouped_plain(x, banks),
                       reps=1)
    plain4 = events_ms(lambda: l1_sliding_distance_grouped_bwd_plain(
        x, banks, gs), reps=1)
    taps = sum(2 * b * n * c * (t - l + 1) * l for l in lengths)
    outb = sum(4 * b * n * c * (t - l + 1) for l in lengths)
    sb = sum(4 * n * c * l for l in lengths)
    bms3, by3 = bound_ms(4 * b * c * t + sb + outb, taps, PEAK_FP32)
    bms4, by4 = bound_ms(4 * b * c * t + 2 * sb + outb, taps, PEAK_FP32)
    ms3, ms4 = (ms3a + ms3b) / 2, (ms4a + ms4b) / 2
    print(f"[K3] six flagship banks, B={b}: kernel {ms3a:.4f}/{ms3b:.4f} ms, "
          f"six K1 {ms1a:.4f}/{ms1b:.4f} ms (in turns), plain {plain3:.3f} "
          f"ms, bound {bms3:.4f} ms ({by3}); equal to K1 bit for bit, max "
          f"abs err {err3:.3e} against the plain version")
    print(f"[K4] six flagship banks, B={b}: kernel {ms4a:.4f}/{ms4b:.4f} ms, "
          f"six K2 {ms2a:.4f}/{ms2b:.4f} ms (in turns), plain {plain4:.3f} "
          f"ms, bound {bms4:.4f} ms ({by4}); equal to K2 bit for bit and to "
          f"itself on a second run, max abs err {err4:.3e} ({rel4:.3e} x "
          f"max|want|) against the plain version")
    print(f"[K3] [K4] six flagship banks: {issue_floor(taps)}")
    # No library time: no one PyTorch call computes several banks (K1's
    # row times torch.cdist per bank; K2 has none, see phase_k2)
    return ({"name": "K3 shapelet_l1_grouped_fwd", "route": "cuda",
             "source": "sie_tpu_torch/csrc/shapelet_l1_grouped_fwd.cu",
             "replaces": "sie_tpu/ops/pallas/shapelet_pallas.py:504",
             "max_abs_err": err3, "ms": ms3, "plain_ms": plain3,
             "bound_ms": bms3, "bound_by": by3, "library_ms": None},
            {"name": "K4 shapelet_l1_grouped_bwd", "route": "cuda",
             "source": "sie_tpu_torch/csrc/shapelet_l1_grouped_bwd.cu",
             "replaces": "sie_tpu/ops/pallas/shapelet_pallas.py:561",
             "max_abs_err": err4, "ms": ms4, "plain_ms": plain4,
             "bound_ms": bms4, "bound_by": by4, "library_ms": None})


def phase_fused(unfused_outs: dict) -> dict:
    """The flagship with fuse_short_banks=True, at the unfused model's
    weights: served and trained through K3/K4."""
    from sie_tpu_torch.models.registry import build_model
    cfg = flagship_config().replace(fuse_short_banks=True)
    model = build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    outs, _, _, serve_launches = serve_module(cfg, model, {"K3": 1, "K5": 2},
                                              "serve fused")
    e = max(float(np.abs(outs[b].logits - unfused_outs[b].logits).max())
            for b in SERVE_SIZES)
    print(f"[serve fused] against the unfused predictor on the card: max "
          f"|dlogits| {e:.3e}")
    # K3 is K1 bit for bit and the rest of the path is the same code on
    # the same card, so the logits and gradients must be equal, not close
    if e != 0.0:
        fail(f"fused serving differs from unfused serving: {e}")
    del model

    tcfg = train_config(fuse_short_banks=True)
    ds = random_rows(tcfg, 256)
    _, _, _, _, _, launches = train_steps(
        tcfg, ds, {"K3": 1, "K4": 1, "K5": 2, "K6": 2}, WARMUP, FUSED_STEPS,
        "train fused")
    fused = build_model(tcfg, "cuda", torch.Generator().manual_seed(0))
    plain = build_model(train_config(), "cuda",
                        torch.Generator().manual_seed(0))
    batch = (ds.x[:2], ds.y[:2], ds.padding_mask[:2], np.ones(2, np.float32))
    got = gradients(tcfg, fused.train(), "cuda", batch)
    want = gradients(train_config(), plain.train(), "cuda", batch)
    differ = [k for k, w in want.items() if not torch.equal(got[k], w)]
    if differ:
        fail(f"fused gradients differ from unfused ones in {differ}")
    print(f"[train fused] against the unfused card path, 2 rows: all "
          f"{len(want)} parameter gradients equal bit for bit")
    return launches, serve_launches


def profile_ms(fn, names, reps: int = 2) -> dict:
    """Device ms per call of fn() of the kernels whose names contain each of
    `names`, from torch.profiler over reps calls after one warm-up; fails
    if the profiler saw none of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for name in names:
            if name in e.key:
                out[name] += e.self_device_time_total / 1e3 / reps
    if not all(out.values()):
        fail(f"the profiler saw no device time for some of {names}: {out}")
    return out


def phase_long_attention() -> tuple:
    """K5 and K6 at the EigenWorms-shaped model's attention (BH=64, T=17984,
    dk=64), where the JAX package runs K7, K8a and K8b."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from sie_tpu_torch.ops.attention import (
        attention_bwd, attention_bwd_plain_chunked, attention_fwd,
        attention_plain_chunked)
    bh, t, dk, hd = LONG_BH, LONG_T, LONG_DK, LONG_HEADS
    gen = torch.Generator(device="cuda").manual_seed(8)
    scale, seed = 1.0 / dk ** 0.5, 2468
    # max abs errors by dtype: K5's output, K6's dQ (K8a), K6's dK/dV (K8b)
    rows, err = {}, {torch.bfloat16: [0.0] * 3, torch.float32: [0.0] * 3}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (torch.randn((bh, t, dk), generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        esz = q.element_size()
        for rate in (0.0, RATE):
            tag = f"BH={bh} T={t} dk={dk} {str(dtype)[6:]} rate {rate}"
            o, lse = attention_fwd(q, k, v, scale, rate, seed, want_lse=True)
            want = attention_plain_chunked(q[:hd], k[:hd], v[:hd], scale,
                                           rate, seed)
            e5 = float((o[:hd].float() - want.float()).abs().max())
            # x max|want|, as K6's limit: over 17984 keys a typical |o| is
            # ~0.01, below the flagship's absolute limit; in bf16 this is
            # 2.5 or more rounding steps of the largest output
            scl5 = float(want.float().abs().max())
            if not e5 <= K5_TOL[dtype] * scl5:
                fail(f"K5 {tag}: max abs err {e5} > {K5_TOL[dtype]} x {scl5}")
            e_lse = 0.0
            for r0 in range(0, t, 2048):
                sc = torch.matmul(q[:hd, r0:r0 + 2048].float(),
                                  k[:hd].float().transpose(-1, -2))
                if dtype == torch.bfloat16:
                    sc = sc.to(torch.bfloat16).float()
                e_lse = max(e_lse, float(
                    (lse[:hd, r0:r0 + 2048]
                     - torch.logsumexp(sc * scale, dim=-1)).abs().max()))
            del sc
            if not e_lse <= 1e-3:
                fail(f"K5 {tag}: log-sum-exp max abs err {e_lse} > 1e-3")
            run = lambda: attention_bwd(q, k, v, o, do, lse, scale, rate, seed)
            got = run()
            want = attention_bwd_plain_chunked(q[:hd], k[:hd], v[:hd], do[:hd],
                                               scale, rate, seed)
            e6, abs6 = [], []
            for name, a, w in zip("qkv", got, want):
                scl = float(w.float().abs().max())
                e = float((a[:hd].float() - w.float()).abs().max())
                e6.append(e / scl)
                abs6.append(e)
                if not e <= K6_TOL[dtype] * scl:
                    fail(f"K6 {tag} d{name}: max abs err {e} > "
                         f"{K6_TOL[dtype]} x {scl}")
            del got, want
            err[dtype] = [max(a, b) for a, b in
                          zip(err[dtype], (e5, abs6[0], max(abs6[1:])))]
            reps = 3 if dtype == torch.bfloat16 else 2
            ms5 = events_ms(lambda: attention_fwd(q, k, v, scale, rate, seed,
                                                  want_lse=True), reps=reps)
            ms6 = events_ms(run, reps=reps)
            print(f"[long] K5 {tag}: kernel {ms5:.4f} ms, max abs err "
                  f"{e5:.3e} (first {hd} heads), log-sum-exp err {e_lse:.3e};"
                  f" K6: kernel {ms6:.4f} ms, max err dq/dk/dv "
                  f"{e6[0]:.2e}/{e6[1]:.2e}/{e6[2]:.2e} x max|want|")
            if rate != 0.0:
                continue
            passes = profile_ms(run, ("attn_bwd_dq", "attn_bwd_dkv",
                                      "attn_bwd_delta"))
            plain5 = events_ms(lambda: attention_plain_chunked(
                q, k, v, scale, chunk=256), reps=1, warmup=0)
            plain6 = events_ms(lambda: attention_bwd_plain_chunked(
                q, k, v, do, scale, chunk=256), reps=1, warmup=0)
            # the library's time, without its (BH, T, T) math fallback,
            # which this shape does not fit
            q4, k4, v4 = (z.view(8, bh // 8, t, dk).detach().requires_grad_()
                          for z in (q, k, v))
            try:
                with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                                  SDPBackend.EFFICIENT_ATTENTION]):
                    lib5 = events_ms(lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, scale=scale), reps=reps)
                    out4 = F.scaled_dot_product_attention(q4, k4, v4,
                                                          scale=scale)
                    lib6 = events_ms(lambda: torch.autograd.grad(
                        out4, (q4, k4, v4), do.view(8, bh // 8, t, dk),
                        retain_graph=True), reps=reps)
                    del out4
            except RuntimeError as exc:   # no fused library kernel for it
                print(f"[long] {str(dtype)[6:]}: no library time: {exc}")
                lib5 = lib6 = None
            del q4, k4, v4
            # bytes: each input read once, each output written once
            io, lse_b = bh * t * dk * esz, 4 * bh * t
            b5 = attention_bound(4 * io + lse_b, 4 * bh * t * t * dk, dtype)
            b8a = attention_bound(6 * io + lse_b, 6 * bh * t * t * dk, dtype)
            b8b = attention_bound(7 * io + lse_b, 8 * bh * t * t * dk, dtype)
            b6 = attention_bound(8 * io + lse_b, 10 * bh * t * t * dk, dtype)
            print(f"[long] {str(dtype)[6:]} rate 0: K5 {ms5:.4f} ms (plain "
                  f"{plain5:.3f}, sdpa {lib5}, bound {b5[0]:.4f} ms "
                  f"({b5[2]})); K6 {ms6:.4f} ms (plain {plain6:.3f}, sdpa "
                  f"backward {lib6}, bound {b6[0]:.4f} ms ({b6[2]})); "
                  f"profiler per K6 call: dQ pass (K8a) "
                  f"{passes['attn_bwd_dq']:.4f} ms (bound {b8a[0]:.4f}: "
                  f"{b8a[2]}), dK/dV pass (K8b) "
                  f"{passes['attn_bwd_dkv']:.4f} ms (bound {b8b[0]:.4f}: "
                  f"{b8b[2]}), delta pass "
                  f"{passes['attn_bwd_delta']:.4f} ms")
            rows[dtype] = dict(ms5=ms5, ms8a=passes["attn_bwd_dq"],
                               ms8b=passes["attn_bwd_dkv"], plain5=plain5,
                               plain6=plain6, lib5=lib5, lib6=lib6, b5=b5,
                               b8a=b8a, b8b=b8b)
        del q, k, v, do, o, lse
    # the rows: float32, the dtype of the EigenWorms-shaped model's path;
    # K8a and K8b share the plain and library time of the whole backward
    r, e = rows[torch.float32], err[torch.float32]
    att = "sie_tpu/ops/pallas/attention_pallas.py"
    return ({"name": "K7 attention_fwd (kv-blocked)", "route": "cuda",
             "source": "sie_tpu_torch/csrc/attention_fwd.cu",
             "replaces": f"{att}:163", "max_abs_err": e[0], "ms": r["ms5"],
             "plain_ms": r["plain5"], "bound_ms": r["b5"][0],
             "bound_by": r["b5"][1], "library_ms": r["lib5"]},
            {"name": "K8a attention_bwd dQ pass", "route": "cuda",
             "source": "sie_tpu_torch/csrc/attention_bwd.cu",
             "replaces": f"{att}:202", "max_abs_err": e[1],   # dQ
             "ms": r["ms8a"], "plain_ms": r["plain6"],
             "bound_ms": r["b8a"][0], "bound_by": r["b8a"][1],
             "library_ms": r["lib6"]},
            {"name": "K8b attention_bwd dK/dV pass", "route": "cuda",
             "source": "sie_tpu_torch/csrc/attention_bwd.cu",
             "replaces": f"{att}:236", "max_abs_err": e[2],   # dK, dV
             "ms": r["ms8b"], "plain_ms": r["plain6"],
             "bound_ms": r["b8b"][0], "bound_by": r["b8b"][1],
             "library_ms": r["lib6"]})


def long_config(**kw):
    """InterpGN + Transformer at the Config defaults' width on an
    EigenWorms-shaped input (sie_tpu/data/uea.py: 6 channels, 17984 steps,
    5 classes), float32 as run_uea.sh trains UEA, batch 8 (its advice for
    EigenWorms), every sequence length through the fused attention."""
    from sie_tpu_torch.config import Config
    return Config(model="InterpGN", dnn_type="Transformer", data="UEA",
                  dataset="EigenWorms", seq_len=LONG_T, enc_in=6,
                  num_class=5, d_model=512, n_heads=8, e_layers=2, d_ff=2048,
                  fused_attention_max_len=0, batch_size=8, lr=5e-3,
                  dropout=0.0, amp=False, seed=0, **kw)


def strided_launches(cfg, tag: str) -> dict:
    """K1 and K2 launches a training step of an EigenWorms-shaped InterpGN:
    one per polyphase component of each of its strided banks."""
    from sie_tpu_torch.models.sbm import bank_lengths
    from sie_tpu_torch.ops.shapelet import shapelet_stride
    strides = [shapelet_stride(cfg.seq_len, l) for l in bank_lengths(cfg)]
    if min(strides) < 2:
        fail(f"EigenWorms-shaped banks: strides {strides}, want all > 1")
    print(f"[{tag}] banks L={bank_lengths(cfg)}, strides {strides}")
    return {"K1": sum(strides), "K2": sum(strides)}


def phase_train_long() -> dict:
    cfg = long_config()
    want = dict(strided_launches(cfg, "train long"), K5=2, K6=2)
    print(f"[train long] launches a step {want}")
    ds = random_rows(cfg, 2 * cfg.batch_size)
    _, dev, sched, _, _, launches = train_steps(
        cfg, ds, want, LONG_WARMUP, LONG_STEPS, "train long")
    dropout_step(cfg, dev, sched[0], want, "train long")
    return launches


GRAPH_STEPS = 10        # train steps of the graph-against-eager phase
GRAPH_EPOCH = 5         # steps of its staged schedule (one scanned epoch)
LOSS_RTOL = 1e-5        # graph replays against eager steps: losses
PARAM_TOL = 2.1         # x lr: parameters (the amp update limit of
# tests/test_torch_port_train.py: one Adam step moves a weight by ~lr)
EVAL_TOL = 5e-2         # bf16 logits, the scanned eval pass against eager


def graph_trainer(cfg, ds):
    """A trainer of the flagship at the seed-0 weights and generator state,
    with `ds` held on the card."""
    from sie_tpu_torch.train.trainer import Trainer
    t = Trainer(cfg, steps_per_epoch=GRAPH_EPOCH, device="cuda",
                generator=torch.Generator().manual_seed(0))
    return t, t.device_data("train", ds)


def capture_counts(trainer, counts, call) -> dict:
    """The launches counted while `call()` captured one new graph of
    `trainer` (the kernels count at capture, not at replay)."""
    n = len(trainer.captures)
    counts.zero()
    out = call()
    got = counts.read()
    if len(trainer.captures) != n + 1:
        fail(f"expected one capture, got {len(trainer.captures) - n}")
    return out, got


def phase_graphs(smi: str) -> dict:
    """The staged steps as CUDA graphs against the eager indexed steps, at
    the flagship's width with dropout RATE: losses, parameters, launches
    of each captured graph, the scanned eval pass, step medians."""
    cfg = train_config(dropout=RATE)
    ds = random_rows(cfg, 256)
    b = cfg.batch_size
    rng = np.random.default_rng(2)
    steps = [(rng.permutation(len(ds.y))[:b], np.ones(b, np.float32))
             for _ in range(GRAPH_EPOCH)]
    want = {"K1": 6, "K2": 6, "K5": 2, "K6": 2}
    counts = Counts()
    eager, dev_e = graph_trainer(cfg, ds)
    graph, dev_g = graph_trainer(cfg, ds)
    staged = graph.stage_steps(steps, 1.0)
    times = {"eager": [], "graph": []}
    losses = {"eager": [], "graph": []}

    def timed(path, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = fn()
        torch.cuda.synchronize()
        times[path].append(1e3 * (time.perf_counter() - t0))
        losses[path].append(float(loss))

    # in turns: an eager step, then the same step as a graph (the first
    # staged call is the eager warm-up, the second captures and replays)
    for i in range(GRAPH_STEPS):
        k = i % GRAPH_EPOCH
        timed("eager", lambda: eager.train_step_indexed(dev_e, steps[k][0],
                                                        steps[k][1], 1.0))
        if i == 1:
            _, got = capture_counts(graph, counts, lambda: timed(
                "graph", lambda: graph.train_step_staged(dev_g, staged, k)))
            if got != Counts.full(want):
                fail(f"train_step_staged graph: launches {got}, want "
                     f"{Counts.full(want)}")
        else:
            timed("graph", lambda: graph.train_step_staged(dev_g, staged, k))
    # the scanned epoch: a warm-up epoch, then a captured one
    scan, dev_s = graph_trainer(cfg, ds)
    staged_s = scan.stage_steps(steps, 1.0)
    scan_losses = scan.train_epoch_staged(dev_s, staged_s).tolist()
    out, got = capture_counts(scan, counts, lambda: scan.train_epoch_staged(
        dev_s, staged_s))
    scan_losses += out.tolist()
    if got != Counts.full(want, GRAPH_EPOCH):
        fail(f"train_epoch_staged graph: launches {got}, want "
             f"{Counts.full(want, GRAPH_EPOCH)}")
    for path, got_l in (("graph", losses["graph"]), ("scan", scan_losses)):
        err = max(abs(a - e) / abs(e) for a, e in zip(got_l,
                                                      losses["eager"]))
        if not np.isfinite(got_l).all() or err > LOSS_RTOL:
            fail(f"{path} losses {got_l} against eager {losses['eager']}: "
                 f"relative error {err}")
        print(f"[graphs] {path}: {GRAPH_STEPS} losses within {err:.3e} "
              f"relative of the eager steps")
    pe = dict(eager.model.named_parameters())
    for path, t in (("graph", graph), ("scan", scan)):
        worst, equal = 0.0, True
        for name, p in t.model.named_parameters():
            worst = max(worst, float((p - pe[name]).detach().abs().max()))
            equal = equal and torch.equal(p, pe[name])
        if worst > PARAM_TOL * cfg.lr:
            fail(f"{path} parameters differ from eager by {worst}")
        print(f"[graphs] {path}: parameters within {worst:.3e} of eager "
              f"(limit {PARAM_TOL * cfg.lr:.3e}); bit-equal: {equal}")

    # the fused flagship's captured step: K3/K4 in place of K1/K2
    fcfg = train_config(dropout=RATE, fuse_short_banks=True)
    fused, dev_f = graph_trainer(fcfg, ds)
    staged_f = fused.stage_steps(steps, 1.0)
    fused.train_step_staged(dev_f, staged_f, 0)
    (loss_f, _), got = capture_counts(
        fused, counts, lambda: fused.train_step_staged(dev_f, staged_f, 1))
    want_f = Counts.full({"K3": 1, "K4": 1, "K5": 2, "K6": 2})
    if got != want_f or not np.isfinite(float(loss_f)):
        fail(f"fused train_step_staged graph: launches {got}, want "
             f"{want_f}; loss {float(loss_f)}")
    del fused, dev_f, scan, dev_s

    # the scanned eval pass (a warm-up, then a captured pass) against the
    # eager eval step batch by batch, with and without collecting
    eval_steps = [(np.arange(i * b, (i + 1) * b), np.ones(b, np.float32))
                  for i in range(2)]
    staged_e = graph.stage_steps(eval_steps)
    for gating, collect in ((None, False), (0.5, True)):
        graph.eval_epoch_staged_scan(dev_g, staged_e, gating, collect)
        (logits, ce, mloss, info), got = capture_counts(
            graph, counts, lambda: graph.eval_epoch_staged_scan(
                dev_g, staged_e, gating, collect))
        if got != Counts.full({"K1": 6, "K5": 2}, len(eval_steps)):
            fail(f"eval_epoch_staged_scan graph: launches {got}")
        for i, (idx, w) in enumerate(eval_steps):
            want_l, want_i = graph.eval_step(
                (ds.x[idx], ds.y[idx], ds.padding_mask[idx], w), gating)
            err = float((logits[i] - want_l).abs().max())
            if err > EVAL_TOL or not torch.equal(logits[i].argmax(-1),
                                                 want_l.argmax(-1)):
                fail(f"scanned eval batch {i}: max |dlogits| {err}")
            if collect and float((info.eta[i] - want_i.eta).abs().max()) > \
                    EVAL_TOL:
                fail(f"scanned eval batch {i}: gate eta differs")
        print(f"[graphs] eval_epoch_staged_scan (gating {gating}, collect "
              f"{collect}): {len(eval_steps)} batches, logits within "
              f"{err:.3e} of the eager eval step, same argmax; launches "
              f"{got}")
    med = {p: float(np.median(t[2:])) for p, t in times.items()}
    print(f"[graphs] ms per step (B={b}, dropout {RATE}), eager "
          f"train_step_indexed: " + ", ".join(f"{t:.3f}" for t in
                                            times["eager"]))
    print(f"[graphs] ms per step, graph train_step_staged (warm-up, capture, "
          f"replays): " + ", ".join(f"{t:.3f}" for t in times["graph"]))
    print(f"[graphs] median of steps 3-{GRAPH_STEPS}: eager {med['eager']:.3f}"
          f" ms, graph {med['graph']:.3f} ms ({smi}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    return med


CLI_TRIALS = 640     # synthetic CHISCO trials: 448 train rows, 7 steps
CLI_FLAGS = ("--data EEG3 --synthetic_trials 640 --target_channels 122 "
             "--target_timepoints 1651 --model InterpGN --dnn_type "
             "Transformer --num_shapelet 10 --d_model 512 --d_ff 2048 "
             "--n_heads 8 --e_layers 2 --batch_size 64 --lr 5e-3 "
             "--train_epochs 3 --patience 3 --log_interval 1 --seed 0")


def run_cli(argv) -> tuple:
    """sie_tpu_torch.run.main(argv) in this process -> (its printed lines,
    its results); the lines are echoed."""
    import contextlib
    import io
    from sie_tpu_torch.run import main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = main(argv)
    text = out.getvalue()
    print("\n".join("[cli] " + l for l in text.splitlines() if l.strip()))
    return text, results


def cli_args(tmp: str) -> list:
    """Phase 15's flagship command line with its directories under tmp."""
    return CLI_FLAGS.split() + [
        "--data_root", os.path.join(tmp, "no_chisco"),
        "--result_dir", os.path.join(tmp, "result"),
        "--cache_dir", os.path.join(tmp, "cache")]


def phase_cli(tmp: str) -> dict:
    """The flagship experiment through the command line on synthetic
    CHISCO: train, checkpoint and test; a re-run that skips training and
    reproduces the test accuracy; a run under --scan_epoch. The kernels'
    counts are read over the first run, the path's main run. Its
    checkpoint stays in tmp/ck for the bundle phase."""
    counts = Counts()
    common = cli_args(tmp)
    first = common + ["--checkpoint_dir", os.path.join(tmp, "ck")]
    t0 = time.perf_counter()
    counts.zero()   # the path's main run
    text, res = run_cli(first)
    launches = counts.read()
    secs = time.perf_counter() - t0
    epochs = re.findall(r"Epoch \d+/3 \| Train Loss (\S+) \| Val Loss "
                        r"(\S+)", text)
    if len(epochs) != 3 or not all(np.isfinite(float(v)) for e in epochs
                                   for v in e):
        fail(f"the CLI run logged epochs {epochs}")
    csv_path = re.search(r"Test summary saved at: (\S+)", text)
    if "Test accuracy" not in text or not csv_path or \
            not os.path.exists(csv_path.group(1)):
        fail("the CLI run wrote no test accuracy or CSV")
    graphs = re.search(r"CUDA graphs captured: (\d+)", text)
    if not graphs or int(graphs.group(1)) < 2:
        fail("the CLI run captured no train and eval graphs")
    for k in ("K1", "K2", "K5", "K6"):
        if not launches[k]:
            fail(f"the CLI run launched no {k}: {launches}")
    acc = res[0][2]["accuracy"]
    text2, res2 = run_cli(first)
    if "checkpoint exists — skipping training" not in text2 or \
            res2[0][2]["accuracy"] != acc or res2[0][1] != res[0][1]:
        fail(f"the re-run did not skip training or gave accuracy "
             f"{res2[0][2]['accuracy']} (loss {res2[0][1]}), not {acc} "
             f"({res[0][1]})")
    text3, res3 = run_cli(common + ["--scan_epoch", "--checkpoint_dir",
                                    os.path.join(tmp, "ck_scan")])
    if len(re.findall(r"Epoch \d+/3 \| Train Loss", text3)) != 3 or \
            "Test accuracy" not in text3:
        fail("the --scan_epoch run did not train and test")
    print(f"[cli] {secs:.1f} s for the first run; test accuracy {acc:.2f}%, "
          f"the same on the re-run; --scan_epoch {res3[0][2]['accuracy']:.2f}"
          f"%; launches over the first run {launches}")
    return launches


# ---- the BatchNorm backbones (InterpGN + FCN/ResNet, EEGCNN) -------------
UEA_SCHEDULE = 4       # steps of the staged schedule of the UEA paths
UEA_STEPS = 6          # eager steps of InterpGN + FCN, each followed by the
# same step as a graph (warm-up, capture, replays)
RESNET_STEPS = 3       # the same for InterpGN + ResNet
F32_TOL = 1e-4         # f32 logits, card vs CPU plain path (summation order)
EEG_ROWS = 256         # random CHISCO-shaped rows held on the card
EEG_STEPS = 8          # eager EEGCNN steps, each followed by a graph step
EEG_DROPOUT_STEPS = 3  # the same at the config's dropout 0.1


def uea_config(dnn_type: str):
    """InterpGN + `dnn_type` as run_uea.sh trains it (f32; num_shapelet 10,
    lambda_div and lambda_reg 0.1, epsilon 1, gating_value 1, lr 5e-3) at
    the EigenWorms shape (sie_tpu/data/uea.py: 6 channels, 17984 steps, 5
    classes) with the batch of 8 that run_uea.sh advises for it."""
    from sie_tpu_torch.config import Config
    return Config(model="InterpGN", dnn_type=dnn_type, data="UEA",
                  dataset="EigenWorms", seq_len=LONG_T, enc_in=6,
                  num_class=5, num_shapelet=10, lambda_div=0.1,
                  lambda_reg=0.1, epsilon=1.0, gating_value=1.0, lr=5e-3,
                  batch_size=8, dropout=0.0, amp=False, seed=0)


def eegcnn_config(**kw):
    """bench.py's second configuration (bench_eegcnn): EEGCNN at the
    CHISCO shape, B=64, T=845, C=122, 3 classes, amp, the eegcnn_*
    defaults of Config and its d_model 512 (so cnn_projection is on)."""
    from sie_tpu_torch.config import Config
    return Config(data="EEG3", model="EEGCNN", seq_len=845, enc_in=122,
                  num_class=3, batch_size=64, amp=True, seed=0, **kw)


def batch_stats(model) -> dict:
    from sie_tpu_torch.compat.from_jax import batch_stats_buffers
    return {k: v.clone() for k, v in batch_stats_buffers(model).items()}


def graph_against_eager(cfg, ds, sched, n: int, want: dict, tag: str,
                        exact: bool, stats: bool = True,
                        unused: frozenset = frozenset()):
    """Two trainers from the seed-0 weights and generator state, `ds` held
    on the card: `n` eager `train_step_indexed` steps over the schedule
    `sched`, each followed by the same step through `train_step_staged`
    (the first its eager warm-up, the second the capture of its CUDA
    graph, later ones replays). Each eager step launches `want`, the
    warm-up and the capture the same, a replay nothing. After every step
    the losses, parameters and BatchNorm buffers of the two are compared:
    bit for bit when `exact`, else within LOSS_RTOL and PARAM_TOL x lr.
    Fails unless every buffer and parameter moved (the names in `unused`,
    parameters the loss never reads, excepted; with `stats`, the model
    must have BatchNorm buffers). Returns (the eager trainer, the median
    eager and graph step ms over the replays, whether all was
    bit-equal)."""
    from sie_tpu_torch.train.trainer import Trainer
    counts = Counts()
    mk = lambda: Trainer(cfg, steps_per_epoch=len(sched), device="cuda",
                         generator=torch.Generator().manual_seed(0))
    eager, graph = mk(), mk()
    dev_e, dev_g = eager.device_data("train", ds), graph.device_data(
        "train", ds)
    staged = graph.stage_steps(sched, 1.0)
    start_p = {k: p.detach().clone() for k, p in
               eager.model.named_parameters()}
    start_s = batch_stats(eager.model)
    expect, none = Counts.full(want), Counts.full({})
    times = {"eager": [], "graph": []}
    bit_equal = True

    def timed(path, fn):
        c0 = counts.read()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = fn()
        torch.cuda.synchronize()
        times[path].append(1e3 * (time.perf_counter() - t0))
        return loss, counts.since(c0)

    for i in range(n):
        k = i % len(sched)
        le, got = timed("eager", lambda: eager.train_step_indexed(
            dev_e, sched[k][0], sched[k][1], 1.0))
        if got != expect or not np.isfinite(float(le)):
            fail(f"{tag} eager step {i}: launches {got}, want {expect}; "
                 f"loss {float(le)}")
        lg, got = timed("graph", lambda: graph.train_step_staged(
            dev_g, staged, k))
        if got != (expect if i < 2 else none):
            fail(f"{tag} graph step {i}: launches {got}")
        pairs = [(le, lg)] + [(p.detach(), q.detach()) for p, q in zip(
            eager.model.parameters(), graph.model.parameters())] + [
            (a, b) for a, b in zip(batch_stats(eager.model).values(),
                                   batch_stats(graph.model).values())]
        same = all(torch.equal(a, b) for a, b in pairs)
        bit_equal = bit_equal and same
        if exact and not same:
            fail(f"{tag} step {i}: the graph's loss, parameters or "
                 f"BatchNorm buffers differ from the eager step's")
        err = abs(float(lg) - float(le)) / abs(float(le))
        worst = max(float((p - q).abs().max()) for p, q in pairs[1:])
        if err > LOSS_RTOL or worst > PARAM_TOL * cfg.lr:
            fail(f"{tag} step {i}: graph loss {float(lg)} against eager "
                 f"{float(le)}; worst tensor difference {worst}")
    still = [k for k, p in eager.model.named_parameters()
             if torch.equal(p, start_p[k]) and k not in unused]
    frozen = [k for k, v in batch_stats(eager.model).items()
              if torch.equal(v, start_s[k])]
    if still or frozen or (stats and not start_s):
        fail(f"{tag}: parameters {still} or BatchNorm buffers {frozen} did "
             f"not move ({len(start_s)} buffers)")
    med = {p: float(np.median(t[2:])) for p, t in times.items()}
    for path, t in times.items():
        print(f"[{tag}] ms per step (B={cfg.batch_size}), {path}: "
              + ", ".join(f"{v:.3f}" for v in t))
    print(f"[{tag}] {n} steps: losses, parameters and {len(start_s)} "
          f"BatchNorm buffers of the graph bit-equal to eager: {bit_equal}; "
          f"every buffer moved; medians of steps 3-{n}: eager "
          f"{med['eager']:.3f} ms, graph {med['graph']:.3f} ms")
    return eager, med, bit_equal


def eval_against_cpu(trainer, ds, rows: int, tol: float, tag: str) -> None:
    """Eval logits of `rows` rows on the card (`Trainer.eval_step`, running
    statistics) against a CPU copy of the model (the plain path), within
    `tol`, with the same argmax; the buffers do not move."""
    before = batch_stats(trainer.model)
    batch = (ds.x[:rows], ds.y[:rows], ds.padding_mask[:rows],
             np.ones(rows, np.float32))
    got, _ = trainer.eval_step(batch)
    cpu = copy.deepcopy(trainer.model).cpu().eval()
    with torch.no_grad():
        want, _ = cpu(torch.from_numpy(batch[0]), torch.from_numpy(batch[2]))
    got = got.float().cpu()
    e = float((got - want).abs().max())
    if not e <= tol or not torch.equal(got.argmax(-1), want.argmax(-1)):
        fail(f"{tag} eval logits differ from the CPU plain path: {e}")
    after = batch_stats(trainer.model)
    if not all(torch.equal(before[k], after[k]) for k in before):
        fail(f"{tag}: an eval step moved the BatchNorm buffers")
    print(f"[{tag}] eval, {rows} rows: card vs CPU plain path max "
          f"|dlogits| {e:.3e} (limit {tol}), same argmax; buffers unmoved")


def phase_uea(dnn_type: str, steps: int, exact: bool, tag: str) -> dict:
    """InterpGN + `dnn_type` at the EigenWorms shape as run_uea.sh trains
    it: eager steps against graph replays, launches (K1 = K2 = the
    polyphase components of the strided banks, K3-K6 none), moved
    BatchNorm buffers, eval logits against the CPU plain path. Returns
    the launches counted over the path's run."""
    cfg = uea_config(dnn_type)
    want = strided_launches(cfg, tag)
    ds = random_rows(cfg, UEA_SCHEDULE * cfg.batch_size)
    rng = np.random.default_rng(3)
    sched = [(rng.permutation(len(ds.y))[:cfg.batch_size],
              np.ones(cfg.batch_size, np.float32))
             for _ in range(UEA_SCHEDULE)]
    counts = Counts()
    counts.zero()   # the path's main run
    eager, _, _ = graph_against_eager(cfg, ds, sched, steps, want, tag,
                                      exact)
    launches = counts.read()
    eval_against_cpu(eager, ds, 2, F32_TOL, tag)
    print(f"[{tag}] launches over the run {launches}")
    return launches


def phase_eegcnn(smi: str) -> None:
    """bench.py's EEGCNN: graph replays against eager steps (bit-equal at
    dropout 0; within limits at the config's dropout 0.1), no kernel
    launch, and a 64-row request through Predictor(cfg, variables) from
    the flax-layout variables of the trained model against the CPU."""
    from sie_tpu_torch.compat.from_jax import to_jax_variables
    from sie_tpu_torch.serve import Predictor
    cfg = eegcnn_config(eegcnn_dropout1=0.0, eegcnn_dropout2=0.0)
    ds = random_rows(cfg, EEG_ROWS)
    rng = np.random.default_rng(4)
    sched = [(rng.permutation(EEG_ROWS)[:cfg.batch_size],
              np.ones(cfg.batch_size, np.float32)) for _ in range(4)]
    counts = Counts()
    counts.zero()   # the path's main run
    eager, med, _ = graph_against_eager(cfg, ds, sched, EEG_STEPS, {},
                                        "eegcnn", exact=True)
    if any(counts.read().values()):
        fail(f"EEGCNN launched kernels: {counts.read()}")
    graph_against_eager(eegcnn_config(), ds, sched, EEG_DROPOUT_STEPS, {},
                        "eegcnn dropout 0.1", exact=False)
    variables = to_jax_variables(eager.model)
    card = Predictor(cfg, variables, device="cuda", max_batch=64)
    cpu = Predictor(cfg, variables, device="cpu", max_batch=64)
    x = ds.x[:64]
    card.predict(x)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        got = card.predict(x)
        times.append(1e3 * (time.perf_counter() - t0))
    want = cpu.predict(x)
    e = float(np.abs(got.logits - want.logits).max())
    if not np.isfinite(got.logits).all() or not e <= SERVE_TOL or \
            not (got.classes == want.classes).all():
        fail(f"EEGCNN served logits differ from the CPU plain path: {e}")
    scopes = len(variables["batch_stats"]["eegcnn"])
    print(f"[eegcnn] Predictor(cfg, variables) with {scopes} BatchNorm "
          f"scopes: 64 rows within {e:.3e} of the CPU plain path "
          f"(limit {SERVE_TOL}), same classes; ms per request: "
          + ", ".join(f"{t:.3f}" for t in times)
          + f" (median {float(np.median(times)):.3f}); step medians eager "
          f"{med['eager']:.3f}, graph {med['graph']:.3f} ms ({smi})")


UEA_CLI = ("--data UEA --dataset SelfRegulationSCP2 --model InterpGN "
           "--dnn_type FCN --num_shapelet 10 --lambda_div 0.1 "
           "--lambda_reg 0.1 --epsilon 1 --gating_value 1 --lr 5e-3 "
           "--no-amp --batch_size 32 --train_epochs 3 --patience 50 "
           "--log_interval 1 --seed 0")
EEG_CLI = ("--data EEG3 --synthetic_trials 640 --target_channels 122 "
           "--target_timepoints 1651 --model EEGCNN --batch_size 64 "
           "--lr 5e-3 --train_epochs 2 --patience 50 --log_interval 1 "
           "--seed 0")


def cli_twice(argv, epochs: int, bn_scopes: list, tag: str) -> dict:
    """argv through the command line: it trains `epochs` epochs with
    finite losses and tests; its checkpoint holds batch_stats under the
    flax names `bn_scopes`; a re-run skips training at the same test
    accuracy. Returns the launches over the first run."""
    from sie_tpu_torch.run import args_to_config, get_args
    from sie_tpu_torch.train.checkpoint import load_checkpoint
    counts = Counts()
    t0 = time.perf_counter()
    counts.zero()
    text, res = run_cli(argv)
    launches = counts.read()
    secs = time.perf_counter() - t0
    epochs_seen = re.findall(r"Epoch \d+/\d+ \| Train Loss (\S+)", text)
    if len(epochs_seen) != epochs or not all(np.isfinite(float(v))
                                             for v in epochs_seen):
        fail(f"{tag}: the CLI run logged epochs {epochs_seen}")
    if "Test accuracy" not in text:
        fail(f"{tag}: the CLI run wrote no test accuracy")
    cfg = args_to_config(get_args(argv), 0)
    ckdir = os.path.join(cfg.checkpoint_dir, cfg.checkpoint_key())
    stats = load_checkpoint(ckdir)["batch_stats"]
    scopes = sorted(f"{a}/{b}" for a, v in stats.items() for b in v)
    if scopes != bn_scopes or not all(
            np.isfinite(np.asarray(leaf)).all() and np.asarray(leaf).size
            for v in stats.values() for bn in v.values()
            for leaf in bn.values()):
        fail(f"{tag}: checkpoint batch_stats scopes {scopes}, want "
             f"{bn_scopes}")
    text2, res2 = run_cli(argv)
    acc = res[0][2]["accuracy"]
    if "checkpoint exists — skipping training" not in text2 or \
            res2[0][2]["accuracy"] != acc:
        fail(f"{tag}: the re-run did not skip training or gave accuracy "
             f"{res2[0][2]['accuracy']}, not {acc}")
    print(f"[{tag}] {secs:.1f} s for the first run; test accuracy "
          f"{acc:.2f}%, the same on the re-run; checkpoint batch_stats "
          f"{scopes}; launches over the first run {launches}")
    return launches


def phase_cli_bn() -> dict:
    """run_uea.sh's command (InterpGN + FCN, f32, its shapelet flags) on
    a synthetic UEA set at SelfRegulationSCP2's shape (7 dimensions, 1152
    steps, 2 classes, 200 train and 180 test cases) with B=32 and 3
    epochs; EEGCNN on synthetic CHISCO, 2 epochs. Returns the UEA run's
    launches."""
    import tempfile
    from sie_tpu_torch.data.synthetic import write_synthetic_uea
    with tempfile.TemporaryDirectory() as tmp:
        write_synthetic_uea(os.path.join(tmp, "uea"), "SelfRegulationSCP2",
                            n_train=200, n_test=180, n_dims=7, length=1152,
                            n_classes=2, seed=0)
        dirs = lambda name: ["--result_dir", os.path.join(tmp, "result"),
                             "--cache_dir", os.path.join(tmp, "cache"),
                             "--checkpoint_dir", os.path.join(tmp, name)]
        uea = cli_twice(UEA_CLI.split() + ["--data_root",
                                           os.path.join(tmp, "uea")]
                        + dirs("ck_uea"), 3,
                        ["deep_model/bn1", "deep_model/bn2",
                         "deep_model/bn3"], "cli uea_fcn")
        if not uea["K1"] or not uea["K2"]:
            fail(f"the UEA CLI run launched no K1/K2: {uea}")
        eeg = cli_twice(EEG_CLI.split() + ["--data_root",
                                           os.path.join(tmp, "no_chisco")]
                        + dirs("ck_eeg"), 2,
                        ["eegcnn/block1_bn1", "eegcnn/block1_bn2",
                         "eegcnn/block2_bn"], "cli eegcnn")
        if any(eeg.values()):
            fail(f"the EEGCNN CLI run launched kernels: {eeg}")
    return uea


# ---- serving: bundles, the HTTP server, ahead-of-time programs -----------
Q_ATOL, Q_RTOL = 0.05, 0.05   # int8 against f32 bundle logits, and
Q_PROBS = 0.02                # probabilities: tests/test_quant.py's limits
Q_BYTES = 0.3      # bytes the int8 leaves hold (q and scale) / their f32 bytes
WIRE_TOL = 1e-6    # the server's outputs against the in-process predictor
JSON_SIZES = (1, 5)   # rows of the JSON-list requests (b64 and npz: all)
WINDOW_MS = 20     # micro-batching window of the batching server
WINDOW_REQS, WINDOW_ROWS = 8, 8   # concurrent requests and their rows
OUT_FIELDS = ("logits", "probs", "classes", "eta", "p", "d",
              "shapelet_preds", "dnn_preds")


def int8_bytes(model) -> tuple:
    """(bytes the quantised leaves of `model` hold as q and scale, their
    bytes as f32)."""
    state = model.state_dict()
    held = f32 = 0
    for k, q in state.items():
        if q.dtype == torch.int8:
            scale = state[k[:-1] + "1"]   # original0 -> original1
            held += q.numel() + 4 * scale.numel()
            f32 += 4 * q.numel()
    return held, f32


def phase_bundle(tmp: str):
    """Phase 15's command (its checkpoint: training is skipped) with
    --export_bundle and with --quantize_bundle; both bundles loaded on the
    card and served (launches per chunk, f32 logits equal to the
    experiment's weights served in this process, int8 within
    test_quant.py's limits), their resident bytes, and a calibration
    saved and reloaded. Returns (the f32 bundle's predictor, its directory,
    the served inputs, its median ms by size, the launches of both
    bundles' runs)."""
    from sie_tpu_torch.data.provider import data_provider
    from sie_tpu_torch.serve import Predictor
    first = cli_args(tmp) + ["--checkpoint_dir", os.path.join(tmp, "ck")]
    dirs = {"f32": os.path.join(tmp, "bundle"),
            "int8": os.path.join(tmp, "bundle_int8")}
    for kind, d in dirs.items():
        flags = ["--export_bundle", d] + (
            ["--quantize_bundle"] if kind == "int8" else [])
        text, _ = run_cli(first + flags)
        if "checkpoint exists — skipping training" not in text or \
                f"serving bundle exported to {d}" not in text:
            fail(f"the {kind} export did not skip training and export")
    preds, mem = {}, {}
    for kind, d in dirs.items():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        preds[kind] = Predictor.load_bundle(d, max_batch=64)  # on the card
        torch.cuda.synchronize()
        mem[kind] = torch.cuda.memory_allocated() - before
    n_params = sum(p.numel() for p in preds["f32"].model.parameters())
    held, f32_bytes = int8_bytes(preds["int8"].model)
    print(f"[bundle] device bytes after load (torch.cuda.memory_allocated "
          f"delta): f32 {mem['f32']} B, int8 {mem['int8']} B, for "
          f"{n_params} parameters; the int8 leaves hold {held} B of their "
          f"{f32_bytes} f32 B ({held / max(f32_bytes, 1):.4f})")
    if preds["f32"].quantized or not preds["int8"].quantized or \
            not 0 < held <= Q_BYTES * f32_bytes:
        fail(f"the int8 bundle is not resident as int8: {held} B of "
             f"{f32_bytes}")
    # the experiment's weights in this process: its checkpoint, from the
    # bundle's config (checkpoint_dir and key)
    ref = Predictor.from_checkpoint(preds["f32"].cfg, max_batch=64)
    results, launches = {}, Counts.full({})
    for kind in ("f32", "int8"):
        outs, xs, ms, counted = serve_requests(
            preds[kind], {"K1": 6, "K5": 2}, f"bundle {kind}")
        results[kind] = outs, ms
        launches = {k: launches[k] + counted[k] for k in launches}
    e_q = p_q = 0.0
    agree = rows = 0
    for b in SERVE_SIZES:
        f32, q = results["f32"][0][b], results["int8"][0][b]
        if not np.array_equal(f32.logits, ref.predict(xs[b]).logits):
            fail(f"the f32 bundle's logits of {b} rows differ from the "
                 f"experiment's weights served in this process")
        e_q = max(e_q, float(np.abs(q.logits - f32.logits).max()))
        p_q = max(p_q, float(np.abs(q.probs - f32.probs).max()))
        if not np.allclose(q.logits, f32.logits, atol=Q_ATOL, rtol=Q_RTOL) \
                or not np.allclose(q.probs, f32.probs, atol=Q_PROBS):
            fail(f"int8 bundle of {b} rows: max |dlogits| {e_q}, |dprobs| "
                 f"{p_q}")
        # a class may flip only where f32's top two logits are closer than
        # twice the logit error
        top2 = np.sort(f32.logits, -1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * e_q
        if (q.classes != f32.classes)[sure].any():
            fail(f"int8 bundle of {b} rows changes a clear class")
        agree += int((q.classes == f32.classes).sum())
        rows += b
    print(f"[bundle] f32 bundle bit-equal to the experiment's weights at "
          f"{SERVE_SIZES} rows; int8 against f32: max |dlogits| {e_q:.3e}, "
          f"|dprobs| {p_q:.3e}, classes agree on {agree}/{rows}")
    val, _ = data_provider(preds["f32"].cfg, "val")
    t = preds["f32"].calibrate(val.x, val.y)
    cal_dir = os.path.join(tmp, "bundle_calibrated")
    preds["f32"].save_bundle(cal_dir)
    back = Predictor.load_bundle(cal_dir, max_batch=64).temperature
    preds["f32"].temperature = 1.0
    if back != t or not os.path.exists(os.path.join(cal_dir,
                                                    "calibration.json")):
        fail(f"calibration T {t} came back as {back}")
    print(f"[bundle] calibrate on {len(val.y)} held-out rows: T {t:.6f}, "
          f"the same after save_bundle and load_bundle")
    for kind in ("f32", "int8"):
        print(f"[bundle {kind}] ms per request: " + ", ".join(
            f"{b} rows {results[kind][1][b]:.3f}" for b in SERVE_SIZES))
    del preds["int8"], ref
    return preds["f32"], dirs["f32"], xs, results["f32"][1], launches


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http(base: str, path: str, body: bytes = None,
         ctype: str = "application/json", accept: str = "*/*"):
    """(status, content type, body) of one request to the server."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        base + path, data=body,
        headers={"Content-Type": ctype, "Accept": accept})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def start_server(args: list, tmp: str, tag: str):
    """`python -m sie_tpu_torch.serve_http *args` on a free local port;
    returns (the process, its base URL) once /healthz answers."""
    port = free_port()
    log = open(os.path.join(tmp, f"{tag}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sie_tpu_torch.serve_http", *args, "--port",
         str(port)], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    CHILDREN.append(proc)
    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    while True:
        if proc.poll() is not None:
            with open(os.path.join(tmp, f"{tag}.log")) as f:
                fail(f"the {tag} server exited with {proc.returncode}:\n"
                     f"{f.read()[-3000:]}")
        try:
            if http(base, "/healthz")[0] == 200:
                break
        except OSError:
            pass
        if time.perf_counter() - t0 > 300:
            fail(f"the {tag} server did not answer within 300 s")
        time.sleep(0.2)
    print(f"[{tag}] server up in {time.perf_counter() - t0:.1f} s: "
          f"{' '.join(args)}")
    return proc, base


def stop_server(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    CHILDREN.remove(proc)


def npz_bytes(**arrays) -> bytes:
    import io
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def decode(ctype: str, body: bytes) -> dict:
    """The arrays of a /predict response, npz or JSON."""
    import io
    if "npz" in ctype:
        with np.load(io.BytesIO(body), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    return {k: np.asarray(v) for k, v in json.loads(body).items()}


def request(base: str, x: np.ndarray, how: str, **extra):
    """One /predict of rows x: 'json' (nested lists), 'b64' (x_b64 in a
    JSON body, JSON response, as the client sends bulk rows) or 'npz'
    (npz both ways) -> (status, arrays or error, ms)."""
    import base64
    t0 = time.perf_counter()
    if how == "npz":
        code, ctype, body = http(base, "/predict", npz_bytes(x=x, **extra),
                                 "application/x-npz", "application/x-npz")
    else:
        payload = dict(extra)
        if how == "json":
            payload["x"] = x.tolist()
        else:
            payload.update(x_b64=base64.b64encode(
                x.astype("<f4").tobytes()).decode(), shape=list(x.shape))
        code, ctype, body = http(base, "/predict",
                                 json.dumps(payload).encode())
    ms = 1e3 * (time.perf_counter() - t0)
    return code, (decode(ctype, body) if code == 200 else body), ms


def same_outputs(got: dict, want, tag: str, fields=OUT_FIELDS) -> float:
    """Max abs difference of the response arrays against a PredictOutput;
    fails above WIRE_TOL or on a missing field."""
    e = 0.0
    for f in fields:
        w = getattr(want, f)
        if w is None:
            continue
        if f not in got or got[f].shape != w.shape:
            fail(f"{tag}: field {f} missing or of another shape")
        e = max(e, float(np.abs(got[f].astype(np.float64) - w).max()))
    if not e <= WIRE_TOL:
        fail(f"{tag}: max |d| {e} against the in-process predictor")
    return e


def phase_http(tmp: str, pred, bundle_dir: str, xs: dict,
               inproc_ms: dict) -> None:
    """`python -m sie_tpu_torch.serve_http --bundle DIR` on the card:
    health, config, JSON / x_b64 / npz requests against the in-process
    bundle predictor, fields, a malformed body, the metrics; the port's
    client; request times. Then a batching server (in this process, so
    that its dispatches and launches can be read) under concurrent
    requests."""
    from sie_tpu_torch.client import InferenceClient
    proc, base = start_server(["--bundle", bundle_dir, "--max_batch", "64",
                               "--warmup", "1", "64"], tmp, "http")
    sent = errors = 0
    try:
        code, _, body = http(base, "/healthz")
        health = json.loads(body)
        code2, _, body2 = http(base, "/config")
        if code != 200 or health["serving"] != "live" or \
                health["max_batch"] != 64 or health["quantized"] or \
                code2 != 200 or json.loads(body2)["d_model"] != 512:
            fail(f"/healthz or /config: {health}")
        e = 0.0
        # JSON lists of numbers only at the small sizes: a 150-row list is
        # 15.5 M numbers to print and parse (tens of seconds a request)
        plan = [(how, b) for how in ("json", "b64", "npz")
                for b in (JSON_SIZES if how == "json" else SERVE_SIZES)]
        for how, b in plan:
            code, got, _ = request(base, xs[b], how)
            sent += 1
            if code != 200:
                fail(f"{how} request of {b} rows: HTTP {code} {got}")
            e = max(e, same_outputs(got, pred.predict(xs[b]),
                                    f"{how} request of {b} rows"))
        code, got, _ = request(base, xs[5], "b64", fields=["probs"])
        sent += 1
        if code != 200 or set(got) != {"probs", "classes"}:
            fail(f"fields=['probs'] gave {code} {sorted(got)}")
        code, _, body = http(base, "/predict", b"{not json")
        sent += 1
        errors += 1
        if code != 400 or "error" not in json.loads(body):
            fail(f"a malformed body gave HTTP {code}")
        times = {}
        for how in ("json", "b64", "npz"):
            for b in ((1,) if how == "json" else (1, 64)):
                ms = []
                for _ in range(REPEATS):
                    code, _, t = request(base, xs[b], how)
                    sent += 1
                    ms.append(t)
                times[how, b] = ms
        client = InferenceClient(base, encoding="npz")
        out = client.predict(xs[5])
        sent += 1
        e = max(e, same_outputs({f: getattr(out, f) for f in OUT_FIELDS
                                 if getattr(out, f) is not None},
                                pred.predict(xs[5]), "the port's client"))
        if client.health()["status"] != "ok":
            fail("the client's health call")
        metrics = dict(line.rsplit(" ", 1) for line in
                       client.metrics().splitlines()
                       if line.strip() and not line.startswith("#"))
        if int(metrics["sie_tpu_requests_total"]) != sent or \
                int(metrics['sie_tpu_errors_total{code="400"}']) != errors:
            fail(f"/metrics counts {metrics} after {sent} requests, "
                 f"{errors} errors")
    finally:
        stop_server(proc)
    print(f"[http] {len(plan)} requests (JSON lists at {JSON_SIZES} rows, "
          f"x_b64 and npz at {SERVE_SIZES}) equal to the in-process bundle "
          f"predictor: "
          f"max |d| {e:.3e}; fields, 400, /metrics ({sent} requests, "
          f"{errors} error) and the port's client checked")
    for (how, b), ms in times.items():
        print(f"[http] {how} {b} rows: median {np.median(ms):.3f} ms (min "
              f"{min(ms):.3f}, max {max(ms):.3f}) of {REPEATS}; in process "
              f"{inproc_ms[b]:.3f} ms")
    window_batching(pred, xs)


def window_batching(pred, xs: dict) -> None:
    """PredictorServer(batch_window_ms=WINDOW_MS) in this process:
    WINDOW_REQS concurrent requests of WINDOW_ROWS rows take fewer
    dispatches than requests, one K1 set per dispatch, and give each
    request's outputs."""
    from http.server import ThreadingHTTPServer
    from sie_tpu_torch.serve_http import PredictorServer
    srv = PredictorServer(pred, batch_window_ms=WINDOW_MS)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler())
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    x = xs[150][: WINDOW_REQS * WINDOW_ROWS]
    parts = [x[i * WINDOW_ROWS: (i + 1) * WINDOW_ROWS]
             for i in range(WINDOW_REQS)]
    results = [None] * WINDOW_REQS
    counts = Counts()
    try:
        request(base, parts[0], "npz")
        before, c0 = srv.batched_dispatches, counts.read()
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(
                i, request(base, parts[i], "npz")))
            for i in range(WINDOW_REQS)]
        [t.start() for t in threads]
        [t.join(timeout=300) for t in threads]
        dispatches = srv.batched_dispatches - before
        got = counts.since(c0)
    finally:
        httpd.shutdown()
        httpd.server_close()
    if any(r is None or r[0] != 200 for r in results):
        fail(f"batching server: {[r and r[0] for r in results]}")
    if not 1 <= dispatches < WINDOW_REQS or \
            got != Counts.full({"K1": 6, "K5": 2}, dispatches):
        fail(f"batching server: {dispatches} dispatches for {WINDOW_REQS} "
             f"requests, launches {got}")
    e = 0.0
    for part, (_, arrays, _) in zip(parts, results):
        want = pred.predict(part)
        e = max(e, float(np.abs(arrays["logits"] - want.logits).max()))
        # a request served inside a larger bucket runs other GEMM shapes
        if not e <= SERVE_TOL or not np.array_equal(arrays["classes"],
                                                    want.classes):
            fail(f"batching server: max |dlogits| {e} against the request "
                 f"served alone")
    print(f"[http] batching server (window {WINDOW_MS} ms): "
          f"{WINDOW_REQS} concurrent {WINDOW_ROWS}-row requests in "
          f"{dispatches} dispatches, launches {got}; against each request "
          f"served alone max |dlogits| {e:.3e}, same classes")


EXPORT_CHILD = r"""
import json, sys, time
import numpy as np
import sie_tpu_torch.ops
from sie_tpu_torch.ops import attention as A, flash as Fl, shapelet_l1 as S
from sie_tpu_torch.serve import CompiledPredictor
aot, inputs, outputs = sys.argv[1:4]
t0 = time.perf_counter()
cp = CompiledPredictor(aot)
load_s = time.perf_counter() - t0
with np.load(inputs) as z:
    xs = {int(k): z[k] for k in z.files}
fns = {"K1": S.l1_sliding_distance, "K2": S.l1_sliding_distance_bwd,
       "K3": S.l1_sliding_distance_grouped,
       "K4": S.l1_sliding_distance_grouped_bwd, "K5": A.fused_attention,
       "K6": A.attention_bwd, "K9": Fl.flash_attention,
       "K10a": Fl.flash_attention_bwd_dq, "K10b": Fl.flash_attention_bwd_dkv}
read = lambda: {k: f.launches for k, f in fns.items()}
for b, x in xs.items():
    cp.predict(x[: min(b, 64)])                      # warm-up
launches, ms, outs = {}, {}, {}
for b, x in sorted(xs.items()):
    c0, times = read(), []
    for _ in range(3):
        t = time.perf_counter()
        out = cp.predict(x)
        times.append(1e3 * (time.perf_counter() - t))
    launches[b] = {k: (v - c0[k]) // 3 for k, v in read().items()}
    ms[b] = float(np.median(times))
    outs[f"logits_{b}"], outs[f"classes_{b}"] = out.logits, out.classes
np.savez(outputs, **outs)
code = cp.programs[64].graph_module.code
print(json.dumps({
    "models": sorted(m for m in sys.modules
                     if m.startswith("sie_tpu_torch.models")),
    "jax": "jax" in sys.modules, "load_s": load_s,
    "ops": {op: code.count(f"torch.ops.sie_tpu_torch.{op}.default(")
            for op in ("l1_fwd", "l1_grouped_fwd", "attention_fwd")},
    "launches": launches, "ms": ms,
    "total": {k: sum(l[k] for l in launches.values()) * 3 for k in fns}}))
"""


def phase_export(tmp: str, pred, xs: dict) -> dict:
    """The f32 bundle's predictor exported for buckets (1, 64); a fresh
    process that imports sie_tpu_torch.ops and sie_tpu_torch.serve and no
    model code serves it through CompiledPredictor: launches per chunk,
    the registered ops in the graph, outputs against the live predictor;
    then `serve_http --stablehlo DIR` with one request. Returns the
    child's launches."""
    aot = os.path.join(tmp, "aot")
    t0 = time.perf_counter()
    pred.export_stablehlo(aot, batch_sizes=(1, 64))
    export_s = time.perf_counter() - t0
    inputs, outputs = os.path.join(tmp, "aot_in.npz"), os.path.join(
        tmp, "aot_out.npz")
    np.savez(inputs, **{str(b): x for b, x in xs.items()})
    r = subprocess.run([sys.executable, "-c", EXPORT_CHILD, aot, inputs,
                        outputs], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        fail(f"the CompiledPredictor process failed:\n{r.stderr[-3000:]}")
    info = json.loads(r.stdout.strip().splitlines()[-1])
    if info["models"] or info["jax"]:
        fail(f"the CompiledPredictor process imported {info['models']} "
             f"(jax: {info['jax']})")
    if info["ops"] != {"l1_fwd": 6, "l1_grouped_fwd": 0, "attention_fwd": 2}:
        fail(f"the exported graph holds the ops {info['ops']}")
    e = 0.0
    with np.load(outputs) as z:
        for b in SERVE_SIZES:
            chunks = -(-b // 64)
            if info["launches"][str(b)] != Counts.full(
                    {"K1": 6, "K5": 2}, chunks):
                fail(f"exported program, {b} rows: launches "
                     f"{info['launches'][str(b)]}")
            want = pred.predict(xs[b])
            e = max(e, float(np.abs(z[f"logits_{b}"] - want.logits).max()))
            if not e <= SERVE_TOL or not np.array_equal(z[f"classes_{b}"],
                                                        want.classes):
                fail(f"exported program, {b} rows: max |dlogits| {e}")
        aot_logits = z["logits_5"]
    print(f"[export] buckets (1, 64) exported in {export_s:.1f} s; a process "
          f"with no model code loaded them in {info['load_s']:.1f} s; graph "
          f"ops {info['ops']}; launches per request {info['launches']}; "
          f"against the live predictor max |dlogits| {e:.3e} (limit "
          f"{SERVE_TOL}), same classes; ms per request "
          + ", ".join(f"{b} rows {t:.3f}" for b, t in info["ms"].items()))
    proc, base = start_server(["--stablehlo", aot], tmp, "http aot")
    try:   # the first request is the server's first call of its program
        (code, got, first), (code2, _, second) = (
            request(base, xs[5], "npz") for _ in range(2))
    finally:
        stop_server(proc)
    if code != 200 or code2 != 200:
        fail(f"serve_http --stablehlo: HTTP {code}, {code2}: {got}")
    e = float(np.abs(got["logits"] - aot_logits).max())
    if not e <= WIRE_TOL:
        fail(f"serve_http --stablehlo: max |dlogits| {e} against "
             f"CompiledPredictor")
    print(f"[export] serve_http --stablehlo: 5 rows in {first:.3f} ms (the "
          f"first request), {second:.3f} ms (the second); max |dlogits| "
          f"{e:.3e} against CompiledPredictor")
    return info["total"]


# ---- run.py's options past classification ---------------------------------
AUG_ALL = ("noise", "scale", "chdrop", "tshift")
AUG_STEPS = 5          # eager steps against graph steps, augmented
AUG_TIMED = 10         # graph replays timed with and without augmentation
TRAIN_WANT = {"K1": 6, "K2": 6, "K5": 2, "K6": 2}   # a flagship-like step


def padded_rows(cfg, n: int):
    """n CHISCO-shaped rows from np.random.default_rng(5), row i padded
    after 845 - 100 i steps (zero there), and their mask, on the card."""
    rng = np.random.default_rng(5)
    t = cfg.seq_len
    lengths = np.maximum(t - 100 * np.arange(n), 1)
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    x = (rng.normal(size=(n, t, cfg.enc_in)) * 1.5 + 0.3).astype(np.float32)
    return (torch.from_numpy(x * mask[:, :, None]).cuda(),
            torch.from_numpy(mask).cuda())


def check_draws(cfg) -> None:
    """One flagship batch's draws on the card within normal and binomial
    bounds (5 sigma), the noise's sigma from the valid region, the padding
    still exactly zero after all four augmentations."""
    from sie_tpu_torch.data.augment import apply_augmentations, draw
    b, t, c = cfg.batch_size, cfg.seq_len, cfg.enc_in
    gen = torch.Generator(device="cuda").manual_seed(11)
    noise, scale, keep, off = draw(cfg, (b, t, c), gen)
    n = noise.numel()
    p = cfg.augment_chdrop_prob
    rate = float(keep.float().mean())
    checks = {
        "noise mean": abs(float(noise.mean())) <= 5 / np.sqrt(n),
        "noise std": abs(float(noise.std()) - 1) <= 5 / np.sqrt(2 * n),
        "scale mean": abs(float(scale.mean())) <= 5 / np.sqrt(b),
        "chdrop keep rate": abs(rate - (1 - p)) <= 5 * np.sqrt(
            p * (1 - p) / keep.numel()),
        "tshift range": (int(off.min()) >= -cfg.augment_tshift_max
                         and int(off.max()) <= cfg.augment_tshift_max),
        "tshift spread": len(set(off.tolist())) >= 10,
    }
    x, mask = padded_rows(cfg, b)
    noisy, _ = apply_augmentations(cfg.replace(augment=("noise",)), x, mask,
                                   [noise])
    added = (noisy - x)
    worst = 0.0   # |sample std / sigma - 1| over 5 / sqrt(2 n), per row
    for i in range(0, b, 7):
        valid = mask[i] > 0
        want = cfg.augment_noise_std * float(x[i][valid].std(unbiased=False))
        got = float(added[i][valid].std())
        worst = max(worst, abs(got / want - 1) / (
            5 / np.sqrt(2 * added[i][valid].numel())))
        if not (added[i][~valid] == 0).all():
            checks["noise leaves the padding"] = False
    checks["noise sigma"] = worst <= 1.0
    out, out_mask = apply_augmentations(cfg, x, mask, [noise, scale, keep,
                                                       off])
    checks["padding zero"] = bool((out[out_mask == 0] == 0).all()) and \
        bool((out_mask == 0).any())
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"augmentation draws on the card: {bad}")
    print(f"[augment] draws (B={b}): noise mean {float(noise.mean()):+.2e} "
          f"std {float(noise.std()):.5f}; chdrop keep rate {rate:.4f} (want "
          f"{1 - p:.2f}); offsets {int(off.min())}..{int(off.max())}; noise "
          f"sigma against 0.1 x the valid region's std at {worst:.3f} of its "
          f"5-sigma bound (worst row); padding exactly zero")


def phase_augment(smi: str) -> dict:
    """The flagship at dropout RATE with all four augmentations: eager
    indexed steps against staged graph steps (warm-up, capture, replays)
    from the same weights and both generators' state, bit for bit; the
    launches of each step; the draws; eval logits with and without
    augment equal; the median replayed step with and without augment.
    Returns the launches over the eager steps, the warm-up and the
    capture."""
    cfg = train_config(dropout=RATE, augment=AUG_ALL)
    ds = random_rows(cfg, 256)
    b = cfg.batch_size
    rng = np.random.default_rng(6)
    steps = [(rng.permutation(len(ds.y))[:b], np.ones(b, np.float32))
             for _ in range(AUG_STEPS)]
    counts = Counts()
    eager, dev_e = graph_trainer(cfg, ds)
    graph, dev_g = graph_trainer(cfg, ds)
    staged = graph.stage_steps(steps, 1.0)
    want, none = Counts.full(TRAIN_WANT), Counts.full({})
    eager_ms, losses = [], []
    counts.zero()   # the path's main run
    for k in range(AUG_STEPS):
        c0 = counts.read()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        le, _ = eager.train_step_indexed(dev_e, steps[k][0], steps[k][1],
                                         1.0)
        torch.cuda.synchronize()
        eager_ms.append(1e3 * (time.perf_counter() - t0))
        got_e = counts.since(c0)
        c0 = counts.read()
        lg, _ = graph.train_step_staged(dev_g, staged, k)
        got_g = counts.since(c0)
        if got_e != want or got_g != (want if k < 2 else none):
            fail(f"augmented step {k}: launches eager {got_e}, graph "
                 f"{got_g}")
        losses.append((float(le), float(lg)))
        if not np.isfinite(losses[-1][0]) or losses[-1][0] != losses[-1][1]:
            fail(f"augmented step {k}: eager loss {losses[-1][0]}, graph "
                 f"{losses[-1][1]}")
    launches = counts.read()
    if len(graph.captures) != 1:
        fail(f"augmented steps: {len(graph.captures)} captures, want 1")
    pg = dict(graph.model.named_parameters())
    differ = [n for n, p in eager.model.named_parameters()
              if not torch.equal(p, pg[n])]
    if differ:
        fail(f"augmented graph steps: parameters differ from eager: "
             f"{differ[:4]}")
    if not torch.equal(eager.augment_generator.get_state(),
                       graph.augment_generator.get_state()):
        fail("augmented graph steps: the augmentation generators differ")
    print(f"[augment] {AUG_STEPS} eager steps and their graph steps "
          f"(warm-up, capture, replays): losses and parameters bit-equal; "
          f"losses {losses[0][0]:.4f} .. {losses[-1][0]:.4f}; launches a "
          f"step {TRAIN_WANT}")
    check_draws(cfg)

    # eval: the augmented trainer's model in a trainer without augment
    plain_cfg = train_config(dropout=RATE)
    plain, dev_p = graph_trainer(plain_cfg, ds)
    plain.model.load_state_dict(eager.model.state_dict())
    idx = steps[0][0]
    batch = (ds.x[idx], ds.y[idx], ds.padding_mask[idx], steps[0][1])
    if not torch.equal(eager.eval_step(batch)[0], plain.eval_step(batch)[0]):
        fail("eval logits differ with and without augment")

    # graph replays with and without augmentation, in turns
    staged_p = plain.stage_steps(steps, 1.0)
    for k in range(2):   # warm-up and capture
        plain.train_step_staged(dev_p, staged_p, k)
    times = {"augment": [], "plain": []}
    for i in range(AUG_TIMED):
        k = i % AUG_STEPS
        for tag, t, dev, st in (("augment", graph, dev_g, staged),
                                ("plain", plain, dev_p, staged_p)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.train_step_staged(dev, st, k)
            torch.cuda.synchronize()
            times[tag].append(1e3 * (time.perf_counter() - t0))
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"[augment] eager augmented steps ms: " + ", ".join(
        f"{t:.3f}" for t in eager_ms))
    for tag, v in times.items():
        print(f"[augment] graph replays ms, {tag}: " + ", ".join(
            f"{t:.3f}" for t in v))
    print(f"[augment] median replayed step (B={b}, dropout {RATE}): with "
          f"augment {med['augment']:.3f} ms, without {med['plain']:.3f} ms, "
          f"difference {med['augment'] - med['plain']:+.3f} ms ({smi})")
    return launches


REG_TRAIN, REG_TEST = 512, 256   # BIDMC32HR has 5550 / 2399 cases
REG_DIMS, REG_LENGTH = 2, 4000   # BIDMC32HR's shape; subsampled x4 to 1000
REG_EPOCHS = 3
# lr 1e-5: at run.py's default 5e-3 Adam moves each of the 512000 inputs of
# the Transformer's flatten-projection head by ~lr a step, and the logits
# saturate within one step (0.7 -> 254 on the CPU at this width; every
# epoch then has the same validation loss, so the checks below that a
# reload keeps the test loss would hold for any weights)
REG_CLI = ("--task_name regression --data Monash --dataset BIDMC32HR "
           "--model InterpGN --dnn_type Transformer --num_shapelet 10 "
           "--d_model 512 --d_ff 2048 --n_heads 8 --e_layers 2 "
           "--batch_size 64 --lr 1e-5 --train_epochs 3 --patience 3 "
           "--log_interval 1 --seed 0")


def reg_args(tmp: str) -> list:
    return REG_CLI.split() + [
        "--data_root", os.path.join(tmp, "monash"),
        "--checkpoint_dir", os.path.join(tmp, "ck_reg"),
        "--result_dir", os.path.join(tmp, "result"),
        "--cache_dir", os.path.join(tmp, "cache")]


def kernels_at(x, banks, tag: str) -> None:
    """K1 and K2 on the card against their plain versions on `banks`."""
    from sie_tpu_torch.ops.shapelet_l1 import (
        l1_sliding_distance, l1_sliding_distance_bwd,
        l1_sliding_distance_bwd_plain, l1_sliding_distance_plain)
    gen = torch.Generator(device="cuda").manual_seed(9)
    worst = [0.0, 0.0]
    for s in banks:
        w = x.shape[-1] - s.shape[-1] + 1
        g = torch.randn((x.shape[0], s.shape[0], x.shape[1], w),
                        generator=gen, device="cuda")
        for metric in ("euclidean", "sqeuclidean"):
            e1 = float((l1_sliding_distance(x, s, metric)
                        - l1_sliding_distance_plain(x, s, metric)
                        ).abs().max())
            want = l1_sliding_distance_bwd_plain(x, s, g, metric)
            e2 = float((l1_sliding_distance_bwd(x, s, g, metric)
                        - want).abs().max()) / float(want.abs().max())
            worst = [max(worst[0], e1), max(worst[1], e2)]
            if not (e1 <= K1_TOL and e2 <= K2_TOL):
                fail(f"{tag} L={s.shape[-1]} {metric}: K1 err {e1}, K2 err "
                     f"{e2} x max|want|")
    print(f"[{tag}] K1 and K2 against their plain versions at x "
          f"{tuple(x.shape)}, L = {[s.shape[-1] for s in banks]}: K1 max abs "
          f"err {worst[0]:.3e}, K2 {worst[1]:.3e} x max|want|")


def phase_regression(tmp: str) -> dict:
    """--task_name regression --data Monash through the command line at
    BIDMC32HR's shape: per-step launches, finite CRPS losses, CSV and
    checkpoint, a re-run that skips training with the same test loss; the
    card against the CPU plain path on 2 test rows; K1/K2 at C = 2. Returns
    the launches over the first run."""
    from sie_tpu_torch.compat.from_jax import load_jax_variables
    from sie_tpu_torch.data.monash import load_monash_dataset
    from sie_tpu_torch.data.synthetic import write_synthetic_monash
    from sie_tpu_torch.models.registry import build_model
    from sie_tpu_torch.models.sbm import bank_lengths
    from sie_tpu_torch.run import args_to_config, get_args
    from sie_tpu_torch.train import trainer as trainer_mod
    from sie_tpu_torch.train.checkpoint import load_checkpoint
    from sie_tpu_torch.train.regression import make_crps_head
    t0 = time.perf_counter()
    root = os.path.join(tmp, "monash")
    write_synthetic_monash(root, "BIDMC32HR", n_train=REG_TRAIN,
                           n_test=REG_TEST, n_dims=REG_DIMS,
                           length=REG_LENGTH, seed=0)
    print(f"[regression] synthetic BIDMC32HR-shaped archive ({REG_TRAIN}/"
          f"{REG_TEST} cases, {REG_DIMS} x {REG_LENGTH}) written in "
          f"{time.perf_counter() - t0:.1f} s")
    argv = reg_args(tmp)
    counts = Counts()
    real = trainer_mod.Trainer.train_step
    per_step, step_ms = [], []

    def counted(self, batch, beta):
        c0 = counts.read()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = real(self, batch, beta)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t1))
        per_step.append(counts.since(c0))
        return out

    trainer_mod.Trainer.train_step = counted
    try:
        t0 = time.perf_counter()
        counts.zero()   # the path's main run
        text, res = run_cli(argv)
        launches = counts.read()
        secs = time.perf_counter() - t0
    finally:
        trainer_mod.Trainer.train_step = real
    steps = REG_EPOCHS * (REG_TRAIN // 64)
    if len(per_step) != steps or any(c != Counts.full(TRAIN_WANT)
                                     for c in per_step):
        fail(f"regression steps: {len(per_step)} (want {steps}), launches "
             f"{[c for c in per_step if c != Counts.full(TRAIN_WANT)][:2]}")
    epochs = re.findall(r"Epoch \d+/3 \| Train (\S+) \| Val (\S+)", text)
    if len(epochs) != REG_EPOCHS or not all(np.isfinite(float(v))
                                            for e in epochs for v in e) or \
            len({e[1] for e in epochs}) == 1:
        fail(f"the regression run logged epochs {epochs} (a validation "
             f"loss that never moves is a saturated model)")
    cfg = args_to_config(get_args(argv), 0)
    ckdir = os.path.join(cfg.checkpoint_dir, cfg.checkpoint_key())
    csv_path = re.search(r"Test summary saved at: (\S+)", text)
    if not csv_path or not os.path.exists(csv_path.group(1)) or \
            not os.path.exists(os.path.join(ckdir, "checkpoint.msgpack")):
        fail("the regression run wrote no CSV or checkpoint.msgpack")
    test_loss = res[0][1]
    text2, res2 = run_cli(argv)
    if "checkpoint exists — skipping training" not in text2 or \
            res2[0][1] != test_loss or not np.isfinite(test_loss):
        fail(f"the regression re-run did not skip training or gave test "
             f"loss {res2[0][1]}, not {test_loss}")

    # the card against the CPU plain path on 2 test rows: at the seed-0
    # weights, logits and CRPS within 5e-2; at the trained weights the
    # CRPS within 5e-2 and the logits within 5e-2 x their largest
    # magnitude (bf16 keeps 8 bits, and training grows the logits)
    train = load_monash_dataset(root, "BIDMC32HR", "train")
    test = load_monash_dataset(root, "BIDMC32HR", "test",
                               bin_edges=train.bin_edges)
    mcfg = cfg.replace(seq_len=REG_LENGTH // 4, enc_in=REG_DIMS,
                       num_class=len(train.bin_edges))
    head = make_crps_head(train.bin_edges)
    x, mask = test.x[:2, ::4], test.padding_mask[:2, ::4]
    errs = {}
    for tag, variables in (("seed-0", None), ("trained",
                                              load_checkpoint(ckdir))):
        out = {}
        for dev in ("cuda", "cpu"):
            model = build_model(mcfg, dev, torch.Generator().manual_seed(0))
            if variables is not None:
                load_jax_variables(model, variables)
            with torch.no_grad():
                logits, _ = model.eval()(torch.from_numpy(x).to(dev),
                                         torch.from_numpy(mask).to(dev))
            y = torch.from_numpy(test.y[:2]).to(dev)
            out[dev] = (logits.float().cpu(), float(head(
                logits, y, torch.ones(2, device=dev))))
        top = float(out["cpu"][0].abs().max())
        scale = 1.0 if variables is None else max(1.0, top)
        errs[tag] = (float((out["cuda"][0] - out["cpu"][0]).abs().max()),
                     abs(out["cuda"][1] - out["cpu"][1]), top)
        if not (errs[tag][0] <= SERVE_TOL * scale
                and errs[tag][1] <= SERVE_TOL):
            fail(f"regression card vs CPU at the {tag} weights: max "
                 f"|dlogits| {errs[tag][0]} (limit {SERVE_TOL * scale}), "
                 f"|dCRPS| {errs[tag][1]}")
    xc = torch.from_numpy(np.ascontiguousarray(
        train.x[:64, ::4].transpose(0, 2, 1))).cuda()
    gen = torch.Generator(device="cuda").manual_seed(8)
    kernels_at(xc, [torch.randn((10, REG_DIMS, l), generator=gen,
                                device="cuda") for l in bank_lengths(mcfg)],
               "regression")
    med = float(np.median(step_ms[2:]))
    print(f"[regression] {secs:.1f} s for the first run ({steps} steps); "
          f"step ms: " + ", ".join(f"{t:.3f}" for t in step_ms))
    print(f"[regression] median step (B=64, T={mcfg.seq_len}, C={REG_DIMS}, "
          f"steps 3-{steps}) {med:.3f} ms; CRPS epochs {epochs}; test loss "
          f"{test_loss:.6f}, the same on the re-run; launches over the "
          f"first run {launches}")
    for tag, (e, e_crps, top) in errs.items():
        print(f"[regression] card vs CPU on 2 rows at the {tag} weights: "
              f"max |dlogits| {e:.3e} (max |logits| {top:.3f}), |dCRPS| "
              f"{e_crps:.3e}")
    return launches


def phase_torch_ckpt(tmp: str) -> None:
    """Phase 15's flagship checkpoint and phase 24's regression checkpoint
    through --export_torch_ckpt, read back through --import_torch_ckpt on
    the card: the same test accuracy (flagship) and test loss
    (regression); the file's keys and shapes are those that
    export_state_dict gives on the CPU from the checkpoint."""
    from sie_tpu_torch.compat.torch_export import export_state_dict
    from sie_tpu_torch.run import args_to_config, get_args
    from sie_tpu_torch.train.checkpoint import load_checkpoint
    for tag, argv in (("flagship", cli_args(tmp) + [
            "--checkpoint_dir", os.path.join(tmp, "ck")]),
            ("regression", reg_args(tmp))):
        pth = os.path.join(tmp, f"{tag}.pth")
        text, res = run_cli(argv + ["--export_torch_ckpt", pth])
        if "checkpoint exists — skipping training" not in text or \
                f"torch checkpoint exported to {pth}" not in text:
            fail(f"{tag}: --export_torch_ckpt did not load and export")
        imp = [a if a != os.path.join(tmp, "ck") and
               a != os.path.join(tmp, "ck_reg") else
               os.path.join(tmp, f"ck_import_{tag}") for a in argv]
        text2, res2 = run_cli(imp + ["--import_torch_ckpt", pth])
        if "imported torch checkpoint" not in text2 or "Epoch" in text2:
            fail(f"{tag}: --import_torch_ckpt trained or did not import")
        acc = lambda r: r[0][2] and r[0][2]["accuracy"]   # None: regression
        if res2[0][1] != res[0][1] or acc(res2) != acc(res):
            fail(f"{tag}: imported test loss {res2[0][1]}, accuracy "
                 f"{acc(res2)}; exported {res[0][1]}, {acc(res)}")
        cfg = args_to_config(get_args(argv), 0)
        want = export_state_dict(load_checkpoint(os.path.join(
            cfg.checkpoint_dir, cfg.checkpoint_key())), cfg)
        got = torch.load(pth, map_location="cpu", weights_only=True)
        if {k: tuple(v.shape) for k, v in got.items()} != \
                {k: v.shape for k, v in want.items()}:
            fail(f"{tag}: the exported keys or shapes differ from "
                 f"export_state_dict on the CPU")
        what = (f"test accuracy {res[0][2]['accuracy']:.2f}%"
                if res[0][2] else f"test loss {res[0][1]:.6f}")
        print(f"[torch_ckpt] {tag}: {len(got)} keys exported, equal to "
              f"export_state_dict on the CPU in keys and shapes; imported on "
              f"the card: the same {what}")


LOSO_TRIALS = 384    # synthetic CHISCO trials over 3 subjects
LOSO_ACCURACY = {}   # phase 26's accuracy by held-out subject (phase 39 d)
LOSO_CLI = CLI_FLAGS.replace("--synthetic_trials 640",
                             f"--synthetic_trials {LOSO_TRIALS}").replace(
    "--train_epochs 3", "--train_epochs 1") + " --loso --max_subjects 3"


def phase_loso(tmp: str) -> dict:
    """--loso on synthetic CHISCO at the flagship's width: three folds,
    each trained with finite losses, each fold's test set one subject,
    checkpoints under loso-<subject>, the mean printed. Returns the
    launches over the run."""
    import glob
    from sie_tpu_torch.data.eeg import load_eeg_dataset
    from sie_tpu_torch.run import args_to_config, get_args
    argv = LOSO_CLI.split() + [
        "--data_root", os.path.join(tmp, "no_chisco_loso"),
        "--checkpoint_dir", os.path.join(tmp, "ck_loso"),
        "--result_dir", os.path.join(tmp, "result"),
        "--cache_dir", os.path.join(tmp, "cache")]
    counts = Counts()
    t0 = time.perf_counter()
    counts.zero()   # the path's main run
    text, res = run_cli(argv)
    launches = counts.read()
    secs = time.perf_counter() - t0
    folds = res[0][2]["per_fold"]
    losses = re.findall(r"Epoch 1/1 \| Train Loss (\S+) \| Val Loss (\S+)",
                        text)
    if [f["held_out_subject"] for f in folds] != [0, 1, 2] or \
            len(losses) != 3 or not all(np.isfinite(float(v))
                                        for l in losses for v in l):
        fail(f"LOSO: folds {[f['held_out_subject'] for f in folds]}, "
             f"epochs {losses}")
    cfg = args_to_config(get_args(argv), 0)
    subjects = np.concatenate([load_eeg_dataset(cfg, f).subject_ids
                               for f in ("train", "val", "test")])
    for f in folds:
        k = f["held_out_subject"]
        test = load_eeg_dataset(cfg, "test", loso_test_subject=k)
        if set(test.subject_ids.tolist()) != {k} or \
                f["num_samples"] != int((subjects == k).sum()):
            fail(f"LOSO fold {k}: {f['num_samples']} test rows, subjects "
                 f"{set(test.subject_ids.tolist())}")
        if not glob.glob(os.path.join(tmp, "ck_loso", f"loso-{k}", "**",
                                      "checkpoint.msgpack"), recursive=True):
            fail(f"LOSO fold {k}: no checkpoint under loso-{k}")
    LOSO_ACCURACY.update({int(k): float(v) for k, v in re.findall(
        r"\[LOSO\] subject (\d+): acc ([0-9.]+)%", text)})
    mean = re.search(r"LOSO \(3 folds\): accuracy (\S+) \+/- (\S+)", text)
    if not mean or not all(launches[k] for k in TRAIN_WANT):
        fail(f"LOSO: no fold mean printed, or launches {launches}")
    print(f"[loso] {secs:.1f} s for 3 folds ({LOSO_TRIALS} trials); test "
          f"rows {[f['num_samples'] for f in folds]}; accuracy "
          f"{mean.group(1)} +/- {mean.group(2)}; launches {launches}")
    return launches


# ---- InterpGN with the PatchTST and TimesNet experts -----------------------
BACKBONE_STEPS = 4     # eager steps, each followed by the same step as a
# graph (warm-up, capture, replays), of each backbone
SBM_WANT = {"K1": 6, "K2": 6}   # a step of InterpGN + PatchTST or TimesNet
PATCH_BH, PATCH_T = 1952 * 8, 105   # a chunk's (batch, head) rows, patches
BIG_BH = 65544         # (batch, head) rows past gridDim.y's 65535
REMAT_B, REMAT_CHUNK = 16, 512   # the remat check: 1952 series, 4 chunks
TIMESNET_WIDE_B = 8    # the default-width TimesNet pass (cut from B 64)


def patchtst_config():
    """InterpGN + PatchTST at the flagship's data shape and width: B 64,
    T 845, C 122, d_model 512, d_ff 2048, 8 heads, 2 layers, six banks
    of 10, amp, dropout 0.1, the default chunking (4 chunks of 1952
    series, recomputed)."""
    return train_config(dnn_type="PatchTST", dropout=RATE)


def timesnet_config():
    """InterpGN + TimesNet at the width the repo runs it
    (scripts/bench_kernel.py:120-123): d_model 32, d_ff 32, top_k 5,
    num_kernels 6, 2 blocks; the flagship's data shape, amp, dropout
    0.1."""
    return train_config(dnn_type="TimesNet", d_model=32, d_ff=32, top_k=5,
                        num_kernels=6, dropout=RATE)


def seed0_trainer(cfg):
    """A trainer at the seed-0 weights, before any step: the trained ones
    of 4 steps at lr 5e-3 saturate the flatten heads, and their logits
    would agree with the CPU's for that reason alone."""
    from sie_tpu_torch.train.trainer import Trainer
    return Trainer(cfg, steps_per_epoch=1, device="cuda",
                   generator=torch.Generator().manual_seed(0))


def schedule(cfg, n_rows: int, steps: int) -> list:
    rng = np.random.default_rng(3)
    return [(rng.permutation(n_rows)[:cfg.batch_size],
             np.ones(cfg.batch_size, np.float32)) for _ in range(steps)]


def backbone_steps(cfg, tag: str, smi: str):
    """Eager steps against graph replays (bit for bit, K1 6 and K2 6 a
    step and no other kernel), with the counts zeroed just before and read
    just after; the median step and the peak memory. Returns (the eager
    trainer, the rows, the launches)."""
    counts = Counts()
    ds = random_rows(cfg, 4 * cfg.batch_size)
    sched = schedule(cfg, len(ds.y), 4)
    torch.cuda.reset_peak_memory_stats()
    counts.zero()   # the path's main run
    eager, med, _ = graph_against_eager(cfg, ds, sched, BACKBONE_STEPS,
                                        SBM_WANT, tag, True, stats=False)
    launches = counts.read()
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] graph step median {med['graph']:.3f} ms, eager "
          f"{med['eager']:.3f} ms (B={cfg.batch_size}); peak memory "
          f"{peak / 2 ** 30:.3f} GiB (two trainers); {smi}; launches over "
          f"the run {launches}")
    return eager, ds, launches


def attention_pair_ms(q, k, v, do, fn) -> float:
    """CUDA-event ms of fn(q, k, v) forward and backward from do."""
    qg, kg, vg = (z.detach().clone().requires_grad_() for z in (q, k, v))

    def once():
        for z in (qg, kg, vg):
            z.grad = None
        fn(qg, kg, vg).backward(do)
    return events_ms(once, reps=5)


def patch_attention_gate(smi: str) -> None:
    """K5 + K6 at PatchTST's chunk shape (BH 15616 = 1952 series x 8
    heads, T 105, dk 64, bf16), forward and backward, against the plain
    branch that `fused_attention_min_len` = 256 sends it to and against
    scaled_dot_product_attention, in one call; and K5/K6 there at rate 0.1
    against their plain versions, masks included."""
    import torch.nn.functional as F
    from sie_tpu_torch.ops.attention import (attention_bwd_plain,
                                             attention_plain, fused_attention)
    bh, t, dk = PATCH_BH, PATCH_T, 64
    q, k, v, do = (torch.from_numpy(np.random.default_rng(21 + i).normal(
        size=(bh, t, dk)).astype(np.float32)).to("cuda", torch.bfloat16)
        for i in range(4))
    scale = 1.0 / np.sqrt(dk)
    h = 8

    def plain(a, b, c):   # FullAttentionLayer's plain branch, rate 0
        s = torch.matmul(a, b.transpose(-1, -2)).float()
        p = torch.softmax(s * scale, dim=-1)
        return torch.matmul(p.to(c.dtype), c)

    def sdpa(a, b, c):
        four = lambda z: z.view(bh // h, h, t, dk)
        return F.scaled_dot_product_attention(
            four(a), four(b), four(c), scale=scale).view(bh, t, dk)

    kern = lambda a, b, c: fused_attention(a, b, c, scale)
    ms = {name: attention_pair_ms(q, k, v, do, fn) for name, fn in
          (("K5+K6", kern), ("plain", plain), ("sdpa", sdpa))}
    fwd = {"K5": events_ms(lambda: fused_attention(q, k, v, scale), reps=5),
           "plain": events_ms(lambda: plain(q, k, v), reps=5),
           "sdpa": events_ms(lambda: sdpa(q, k, v), reps=5)}
    elem = bh * t * dk * 2   # bytes of one (BH, T, dk) bf16 tensor
    b5 = bound_ms(4 * elem, 4 * bh * t * t * dk, PEAK_BF16)
    b56 = bound_ms(4 * elem + 8 * elem + 4 * bh * t,
                   14 * bh * t * t * dk, PEAK_BF16)
    print(f"[patchtst] attention gate at BH {bh}, T {t}, dk {dk}, bf16 "
          f"({smi}): forward + backward K5+K6 {ms['K5+K6']:.4f} ms, plain "
          f"branch {ms['plain']:.4f} ms, sdpa {ms['sdpa']:.4f} ms (bound "
          f"{b56[0]:.4f} ms, {b56[1]}); forward K5 {fwd['K5']:.4f}, plain "
          f"{fwd['plain']:.4f}, sdpa {fwd['sdpa']:.4f} ms (bound "
          f"{b5[0]:.4f} ms, {b5[1]})")
    qg, kg, vg = (z.clone().requires_grad_() for z in (q, k, v))
    out = fused_attention(qg, kg, vg, scale, RATE, 4321)
    out.backward(do)
    want = attention_plain(q, k, v, scale, RATE, 4321)
    e = float((out.float() - want.float()).abs().max())
    eg = 0.0
    for got, w in zip((qg.grad, kg.grad, vg.grad),
                      attention_bwd_plain(q, k, v, do, scale, RATE, 4321)):
        lim = 2e-2 * max(1.0, float(w.float().abs().max()))
        eg = max(eg, float((got.float() - w.float()).abs().max()) / lim)
    if not e <= 2e-2 or not eg <= 1.0:
        fail(f"K5/K6 at PatchTST's shape, rate {RATE}: |dout| {e}, "
             f"gradient error {eg} of its limit")
    print(f"[patchtst] K5/K6 at BH {bh}, T {t}, rate {RATE} against the "
          f"plain versions: max |dout| {e:.3e} (limit 2e-2), gradients "
          f"within {eg:.3f} of their limit")


def big_bh_launch() -> None:
    """K5 and K6 at BH 65544 (past gridDim.y's 65535), T 105, bf16, rate
    0.1, against the chunked plain versions over all rows and, from bh0,
    over the rows either side of row 65535."""
    from sie_tpu_torch.ops.attention import (attention_bwd_plain_chunked,
                                             attention_plain_chunked,
                                             fused_attention)
    t, dk = PATCH_T, 64
    q, k, v, do = (torch.from_numpy(np.random.default_rng(31 + i).normal(
        size=(BIG_BH, t, dk)).astype(np.float32)).to("cuda", torch.bfloat16)
        for i in range(4))
    scale, seed = 1.0 / np.sqrt(dk), 555
    qg, kg, vg = (z.clone().requires_grad_() for z in (q, k, v))
    out = fused_attention(qg, kg, vg, scale, RATE, seed)
    out.backward(do)
    worst = 0.0
    for lo, hi in ((0, BIG_BH), (65532, 65540)):
        part = lambda z: z[lo:hi].contiguous()
        want = attention_plain_chunked(part(q), part(k), part(v), scale, RATE,
                                       seed, bh0=lo, chunk=32)
        worst = max(worst, float((out[lo:hi].float()
                                  - want.float()).abs().max()) / 2e-2)
        grads = attention_bwd_plain_chunked(part(q), part(k), part(v),
                                            part(do), scale, RATE, seed,
                                            bh0=lo, chunk=32)
        for got, w in zip((qg.grad, kg.grad, vg.grad), grads):
            lim = 2e-2 * max(1.0, float(w.float().abs().max()))
            worst = max(worst, float((got[lo:hi].float()
                                      - w.float()).abs().max()) / lim)
    if not worst <= 1.0:
        fail(f"K5/K6 at BH {BIG_BH}: error {worst} of the limit")
    print(f"[patchtst] K5/K6 at BH {BIG_BH}, T {t}, rate {RATE}: output and "
          f"gradients within {worst:.3f} of their limits against the "
          f"chunked plain versions, all rows and rows 65532-65539 from bh0")


def remat_gradients() -> None:
    """Gradients of InterpGN + PatchTST with patch_remat true and false,
    bit for bit on the card at dropout 0.1: B 16 with 512-series chunks
    (four chunks; the unrecomputed full batch would hold every chunk's
    activations)."""
    from sie_tpu_torch.models.registry import build_model
    grads = []
    cfg = patchtst_config().replace(batch_size=REMAT_B,
                                    patch_chunk_rows=REMAT_CHUNK)
    x = torch.from_numpy(random_rows(cfg, REMAT_B).x).cuda()
    mask = torch.ones(REMAT_B, cfg.seq_len, device="cuda")
    for remat in (True, False):
        m = build_model(cfg.replace(patch_remat=remat), "cuda",
                        torch.Generator().manual_seed(0)).train()
        g = torch.Generator(device="cuda").manual_seed(99)
        logits, _ = m(x, mask, generator=g)
        logits.float().square().sum().backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
        del m
    same = [n for n in grads[0] if torch.equal(grads[0][n], grads[1][n])]
    if len(same) != len(grads[0]):
        fail(f"patch_remat changes the gradients of "
             f"{sorted(set(grads[0]) - set(same))[:4]}")
    print(f"[patchtst] patch_remat true and false at dropout {RATE} (B "
          f"{REMAT_B}, chunks of {REMAT_CHUNK}): all {len(same)} gradients "
          f"bit-equal on the card")


def phase_patchtst(smi: str) -> dict:
    """InterpGN + PatchTST at full width: eager steps against graph
    replays, launches, eval against the CPU plain path, remat gradients,
    the attention gate at T 105, a step through K5/K6, K5/K6 past 65535
    rows. Returns the launches of the training run."""
    from sie_tpu_torch.train.trainer import Trainer
    cfg = patchtst_config()
    eager, ds, launches = backbone_steps(cfg, "patchtst", smi)
    del eager
    eval_against_cpu(seed0_trainer(cfg), ds, 2, SERVE_TOL,
                     "patchtst, seed-0 weights")
    remat_gradients()
    patch_attention_gate(smi)
    fused = Trainer(cfg.replace(fused_attention_min_len=0),
                    steps_per_epoch=1, device="cuda",
                    generator=torch.Generator().manual_seed(0))
    counts = Counts()
    dev = fused.device_data("train", ds)
    c0 = counts.read()
    loss, _ = fused.train_step_indexed(dev, np.arange(cfg.batch_size),
                                       np.ones(cfg.batch_size, np.float32),
                                       1.0)
    got = counts.since(c0)
    # 2 layers x 4 chunks in the forward, again in the recompute; K6 once
    want = Counts.full({"K1": 6, "K2": 6, "K5": 16, "K6": 8})
    if got != want or not np.isfinite(float(loss)):
        fail(f"patchtst with fused_attention_min_len=0: launches {got}, "
             f"want {want}; loss {float(loss)}")
    print(f"[patchtst] a step with fused_attention_min_len=0: loss "
          f"{float(loss):.4f}, launches {got} (K5: 2 layers x 4 chunks, "
          f"forward and recompute)")
    del fused, dev
    big_bh_launch()
    return launches


def wide_timesnet(smi: str) -> None:
    """One forward and backward of InterpGN + TimesNet at run.py's default
    width (d_model 512, d_ff 2048) on B 8 (cut from 64): time and peak
    memory; logits held to the same weights without amp, on the card."""
    from sie_tpu_torch.models.registry import build_model
    cfg = timesnet_config().replace(d_model=512, d_ff=2048, dropout=0.0,
                                    batch_size=TIMESNET_WIDE_B)
    x = torch.from_numpy(random_rows(cfg, TIMESNET_WIDE_B).x).cuda()
    mask = torch.ones(TIMESNET_WIDE_B, cfg.seq_len, device="cuda")
    out = {}
    for amp in (True, False):
        m = build_model(cfg.replace(amp=amp), "cuda",
                        torch.Generator().manual_seed(0)).train()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, _ = m(x, mask)
        if amp:
            logits.float().square().sum().backward()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[amp] = (logits.detach().float(), secs,
                    torch.cuda.max_memory_allocated())
        del m
    e = float((out[True][0] - out[False][0]).abs().max())
    if not e <= SERVE_TOL:
        fail(f"TimesNet at width 512/2048: amp logits {e} from f32")
    print(f"[timesnet] width 512/2048, B {TIMESNET_WIDE_B} ({smi}): forward "
          f"+ backward (amp) {out[True][1]:.3f} s, peak "
          f"{out[True][2] / 2 ** 30:.3f} GiB; forward without amp "
          f"{out[False][1]:.3f} s; max |dlogits| amp vs f32 {e:.3e} (limit "
          f"{SERVE_TOL})")


def periods_against_cpu(trainer) -> None:
    """`fft_periods` on 2 rows with clear spectral peaks (five sinusoids of
    distinct strength), on the card and on the CPU: the same periods; the
    trainer's model's logits of those rows within SERVE_TOL of the CPU
    plain path."""
    from sie_tpu_torch.models.timesnet import fft_periods
    cfg = trainer.cfg
    t = np.arange(cfg.seq_len)
    rng = np.random.default_rng(7)
    x = sum(a * np.sin(2 * np.pi * f * t / cfg.seq_len)[None, :, None]
            for a, f in ((5, 7), (4, 19), (3, 40), (2, 66), (1.5, 101)))
    x = (x + 0.3 * rng.normal(size=(2, cfg.seq_len, cfg.enc_in))).astype(
        np.float32)
    pc, wc = fft_periods(torch.from_numpy(x).cuda(), cfg.top_k)
    pp, wp = fft_periods(torch.from_numpy(x), cfg.top_k)
    if not torch.equal(pc.cpu(), pp):
        fail(f"fft_periods on the card {pc.tolist()}, on the CPU "
             f"{pp.tolist()}")
    ds = type("Rows", (), dict(x=x, y=np.zeros(2, np.int32),
                               padding_mask=np.ones((2, cfg.seq_len),
                                                    np.float32)))()
    eval_against_cpu(trainer, ds, 2, SERVE_TOL, "timesnet, seed-0 weights")
    print(f"[timesnet] fft_periods on 2 rows: card {pc.tolist()} equal to "
          f"the CPU's; weights within "
          f"{float((wc.cpu() - wp).abs().max()):.3e}")


def phase_timesnet(smi: str) -> dict:
    """InterpGN + TimesNet: eager steps against graph replays (bit for bit,
    K1 6 and K2 6 a step), periods and logits against the CPU plain path,
    the default width once. Returns the launches of the training run."""
    cfg = timesnet_config()
    eager, _ds, launches = backbone_steps(cfg, "timesnet", smi)
    del eager
    periods_against_cpu(seed0_trainer(cfg))
    wide_timesnet(smi)
    return launches


BACKBONE_CLI = {
    "PatchTST": CLI_FLAGS.replace("--dnn_type Transformer",
                                  "--dnn_type PatchTST"),
    "TimesNet": CLI_FLAGS.replace("--dnn_type Transformer",
                                  "--dnn_type TimesNet").replace(
        "--d_model 512 --d_ff 2048", "--d_model 32 --d_ff 32 --top_k 5 "
        "--num_kernels 6")}


PROFILED = ("PatchTST",)   # backbones whose CLI run writes a trace


def trace_kernels(prof_dir: str) -> set:
    """The K1 and K2 kernel names found in a --profile_dir trace."""
    import glob
    files = glob.glob(os.path.join(prof_dir, "trace-*.json"))
    if len(files) != 1:
        fail(f"--profile_dir wrote {files}")
    with open(files[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    return {k for k, sym in (("K1", "l1_fwd_kernel"),
                             ("K2", "l1_bwd_partial"))
            if any(sym in n for n in names)}


def poisoned_run(argv) -> str:
    """The command's experiment under debug_nans with one NaN inside a
    train row's valid region: FloatingPointError's text."""
    from sie_tpu_torch.run import args_to_config, get_args
    from sie_tpu_torch.train.experiment import Experiment
    from sie_tpu_torch.utils.profiling import debug_nans
    cfg = args_to_config(get_args(argv), 0)
    with debug_nans():
        exp = Experiment(cfg, verbose=False, device="cuda")
    exp.train_data.x[3, 100, 5] = np.nan
    try:
        exp.train()
    except FloatingPointError as e:
        return str(e)
    fail("--debug_nans did not raise on a NaN in a train row")


def losses_of(path: str) -> list:
    with open(path) as f:
        return [(r["train_loss"], r["val_loss"], r["val_accuracy"])
                for r in map(json.loads, f)]


def backbone_cli(tmp: str, dnn: str) -> dict:
    """The backbone's command line on synthetic CHISCO, 1 epoch: train
    (the counts zeroed before and read after), a re-run that skips
    training with --export_torch_ckpt, --import_torch_ckpt, f32 and int8
    bundles against the live weights, --profile_dir with --debug_nans (the
    same losses, K1 and K2 in the trace), and a NaN that raises."""
    from sie_tpu_torch.data.provider import data_provider
    from sie_tpu_torch.run import args_to_config, get_args
    from sie_tpu_torch.serve import Predictor
    tag = f"cli {dnn}"
    base = BACKBONE_CLI[dnn].replace("--train_epochs 3",
                                     "--train_epochs 1").split() + [
        "--data_root", os.path.join(tmp, "no_chisco"),
        "--result_dir", os.path.join(tmp, "result"),
        "--cache_dir", os.path.join(tmp, "cache")]
    d = lambda name: os.path.join(tmp, f"{dnn}_{name}")
    first = base + ["--checkpoint_dir", d("ck"), "--metrics_jsonl",
                    d("plain.jsonl")]
    counts = Counts()
    t0 = time.perf_counter()
    counts.zero()   # the path's main run
    text, res = run_cli(first)
    launches = counts.read()
    secs = time.perf_counter() - t0
    csv_path = re.search(r"Test summary saved at: (\S+)", text)
    if not csv_path or not os.path.exists(csv_path.group(1)) or \
            "CUDA graphs captured" not in text or \
            not launches["K1"] or not launches["K2"]:
        fail(f"{tag}: no CSV, no graphs or no K1/K2 launches {launches}")
    acc, loss = res[0][2]["accuracy"], res[0][1]
    pth = d("ck.pth")
    text2, res2 = run_cli(first + ["--export_torch_ckpt", pth])
    text3, res3 = run_cli(base + ["--checkpoint_dir", d("ck_import"),
                                  "--import_torch_ckpt", pth])
    if "checkpoint exists — skipping training" not in text2 or \
            "Epoch" in text3 or \
            {res2[0][2]["accuracy"], res3[0][2]["accuracy"]} != {acc} or \
            {res2[0][1], res3[0][1]} != {loss}:
        fail(f"{tag}: re-run / import gave {res2[0][2]['accuracy']}, "
             f"{res3[0][2]['accuracy']}, not {acc}")
    cfg = args_to_config(get_args(first), 0)
    test, _ = data_provider(cfg, "test")
    live = Predictor.from_checkpoint(
        cfg.replace(seq_len=test.seq_len, enc_in=test.enc_in,
                    num_class=test.num_class), max_batch=64)
    x = random_rows(live.cfg, 64).x
    want = live.predict(x)
    errs = {}
    for quantize in (False, True):
        bd = d("bundle_int8" if quantize else "bundle")
        live.save_bundle(bd, quantize=quantize)
        got = Predictor.load_bundle(bd, max_batch=64).predict(x)
        errs[quantize] = float(np.abs(got.logits - want.logits).max())
        ok = (np.allclose(got.logits, want.logits, atol=Q_ATOL, rtol=Q_RTOL)
              if quantize else errs[quantize] <= F32_TOL)
        if not ok:
            fail(f"{tag}: bundle (int8 {quantize}) logits {errs[quantize]} "
                 f"from the live weights")
    # --profile_dir on PatchTST only: TimesNet's trace of its eager ops
    # took ~40 s to write (PERF.md §7)
    profiled = dnn in PROFILED
    prof = d("profile")
    text4, res4 = run_cli(base + ["--checkpoint_dir", d("ck_debug"),
                                  "--debug_nans",
                                  "--metrics_jsonl", d("debug.jsonl")]
                          + (["--profile_dir", prof] if profiled else []))
    seen = trace_kernels(prof) if profiled else {"K1", "K2"}
    if losses_of(d("debug.jsonl")) != losses_of(d("plain.jsonl")) or \
            res4[0][2]["accuracy"] != acc or seen != {"K1", "K2"} or \
            "CUDA graphs captured" not in text4:
        fail(f"{tag}: --debug_nans changed the losses "
             f"{losses_of(d('debug.jsonl'))} against "
             f"{losses_of(d('plain.jsonl'))}, or the trace holds {seen}")
    msg = poisoned_run(base + ["--checkpoint_dir", d("ck_nan")])
    if not re.search(r"train step \d+: the first non-finite value came "
                     r"from \S+", msg):
        fail(f"{tag}: --debug_nans raised {msg!r}")
    traced = (f" with --profile_dir: the same losses, {sorted(seen)} in "
              f"the trace" if profiled else ": the same losses")
    print(f"[{tag}] {secs:.1f} s for the first run (1 epoch); test accuracy "
          f"{acc:.2f}%, the same after the re-run, --export_torch_ckpt and "
          f"--import_torch_ckpt; bundles against the live weights at 64 "
          f"rows: f32 {errs[False]:.3e}, int8 {errs[True]:.3e}; "
          f"--debug_nans{traced}; a NaN in a train row: {msg}; launches "
          f"over the first run {launches}")
    return launches


def phase_backbone_cli(tmp: str) -> dict:
    """Both backbones through the command line -> their launches by
    backbone."""
    return {dnn: backbone_cli(tmp, dnn) for dnn in ("PatchTST", "TimesNet")}


# ---- phases 30-32: --stream_from_disk and the tasks ------------------------
STREAM_STEPS = 6        # timed steps of each feed (after warm-up)
TASK_STEPS = 5          # eager steps of each task model
TASK_LOSS_TOL = 5e-2    # first step's loss, card vs CPU plain path, relative
TASK_BATCH = 32


def rss_bytes() -> tuple:
    """This process's resident bytes and the shared part of them (mapped
    file pages it has touched), from /proc/self/statm."""
    with open("/proc/self/statm") as f:
        _size, resident, shared = (int(v) for v in f.read().split()[:3])
    page = os.sysconf("SC_PAGE_SIZE")
    return resident * page, shared * page


def idle_share(step, n: int) -> tuple:
    """(wall ms a call, idle share) of n calls of step() under
    torch.profiler: 1 - the union of the device's kernel and copy
    intervals over the wall time (`utils.profiling.idle_share`, which
    raises if the profiler saw no device time or more than the wall)."""
    from torch.profiler import ProfilerActivity, profile
    from sie_tpu_torch.utils import profiling
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    try:
        return wall / n, profiling.idle_share(prof, wall)
    except RuntimeError as e:
        fail(str(e))


def timed(step, n: int) -> list:
    """Host-clock ms of n calls of step(), each ended by a synchronise."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def phase_stream(tmp: str, smi: str) -> dict:
    """Phase 15's flagship command for 1 epoch, held on the device and
    with --stream_from_disk: three stream_EEG3_* caches, bit-equal train
    losses and test accuracy, a re-run that opens the caches without the
    registry loader, each prefetched batch of an epoch equal to a plain
    copy of its rows; ms a step and idle share of the host-fed streamed
    steps against the device-resident replays, and the host RSS growth
    while streaming. Returns the streamed run's launches."""
    import itertools
    from sie_tpu_torch.data import provider
    from sie_tpu_torch.data.stream import prefetch_to_device
    from sie_tpu_torch.run import args_to_config, get_args
    from sie_tpu_torch.train.experiment import Experiment
    counts = Counts()
    run = lambda name, *extra: cli_args(tmp) + [
        "--train_epochs", "1", "--checkpoint_dir", os.path.join(tmp, name),
        "--metrics_jsonl", os.path.join(tmp, f"{name}.jsonl"), *extra]
    _, ram = run_cli(run("ck_ram"))
    streamed = run("ck_stream", "--stream_from_disk")
    counts.zero()   # the path's main run
    t0 = time.perf_counter()
    _, res = run_cli(streamed)
    secs = time.perf_counter() - t0
    launches = counts.read()
    if not all(launches[k] for k in ("K1", "K2", "K5", "K6")):
        fail(f"the streamed run did not launch every kernel: {launches}")
    cache = os.path.join(tmp, "cache")
    dirs = sorted(d for d in os.listdir(cache) if d.startswith("stream_EEG3_"))
    if sorted(d.split("_")[2] for d in dirs) != ["test", "train", "val"]:
        fail(f"the stream caches under {cache}: {dirs}")
    losses = lambda name: [json.loads(l)["train_loss"] for l in
                           open(os.path.join(tmp, f"{name}.jsonl"))]
    got, want = losses("ck_stream"), losses("ck_ram")
    acc, acc_ram = res[0][2]["accuracy"], ram[0][2]["accuracy"]
    # the same rows in the same order into steps PR 7 showed bit-equal
    # between eager and replayed: anything but equality is a fault (a feed
    # that hands the step a batch before its copy lands, or reuses its
    # memory while the step reads it)
    if len(got) != 1 or got != want or acc != acc_ram or \
            res[0][1] != ram[0][1]:
        fail(f"streamed run not bit-equal to the run held on the device: "
             f"losses {got} against {want}, accuracy {acc} against "
             f"{acc_ram}, {res[0][1]} against {ram[0][1]}")
    calls = []
    real = provider.DATA_REGISTRY["EEG3"]
    provider.DATA_REGISTRY["EEG3"] = \
        lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        text, again = run_cli(streamed)
    finally:
        provider.DATA_REGISTRY["EEG3"] = real
    if calls or "checkpoint exists" not in text or \
            again[0][2]["accuracy"] != acc:
        fail(f"the re-run called the registry loader {len(calls)} times or "
             f"gave accuracy {again[0][2]['accuracy']}, not {acc}")

    cfg = args_to_config(get_args(streamed), 0)
    rss0 = rss_bytes()
    exp = Experiment(cfg, verbose=False, device="cuda")
    if exp.device_resident or not isinstance(exp.train_data.x, np.memmap):
        fail("--stream_from_disk: the splits are not memmaps fed from the "
             "host")
    tr = exp.trainer
    feed = prefetch_to_device(itertools.chain.from_iterable(
        exp.train_loader.epoch(e) for e in itertools.count()), device="cuda")
    step_s = lambda: tr.train_step(next(feed), 1.0)
    peak = [0, 0]      # resident and shared growth since before it
    times_s = []
    for _ in range(STREAM_STEPS + 1):
        times_s += timed(step_s, 1)
        peak = [max(p, now - then) for p, now, then in
                zip(peak, rss_bytes(), rss0)]
    times_s = times_s[1:]     # the first step is the warm-up
    _, idle_s = idle_share(step_s, 3)
    # each prefetched batch of epoch 0, read on the consumer's stream as it
    # arrives, against the same memmap rows copied plainly
    n_checked = 0
    for fed, rows in zip(prefetch_to_device(exp.train_loader.epoch(0),
                                            device="cuda"),
                         exp.train_loader.epoch(0)):
        if not all(torch.equal(f, torch.from_numpy(np.asarray(r)).cuda())
                   for f, r in zip(fed, rows)):
            fail(f"prefetched batch {n_checked} differs from a plain copy "
                 f"of its rows")
        n_checked += 1
    del exp, tr, feed
    res_exp = Experiment(cfg.replace(stream_from_disk=False), verbose=False,
                         device="cuda")
    tr = res_exp.trainer
    dev = tr.device_data("train", res_exp.train_data)
    steps = list(res_exp.train_loader.epoch_indices(0))
    staged = tr.stage_steps(steps, 1.0)
    ks = itertools.count()
    step_r = lambda: tr.train_step_staged(dev, staged, next(ks) % len(steps))
    step_r()
    step_r()          # warm-up, capture
    times_r = timed(step_r, STREAM_STEPS)
    _, idle_r = idle_share(step_r, 3)
    on_disk = os.path.getsize(os.path.join(
        cache, [d for d in dirs if "_train_" in d][0], "x.npy"))
    print(f"[stream] {secs:.1f} s for the streamed 1-epoch run; train losses "
          f"{got} against {want} held on the device (bit-equal), test "
          f"accuracy {acc:.2f}% against {acc_ram:.2f}%; the re-run opened "
          f"{len(dirs)} caches without the loader; launches {launches}; "
          f"{n_checked} prefetched batches equal to plain copies")
    print(f"[stream] ms a step (B 64): streamed host-fed eager "
          f"{np.median(times_s):.3f} (idle share {idle_s:.3f}) against "
          f"device-resident replays {np.median(times_r):.3f} (idle share "
          f"{idle_r:.3f}); host RSS growth from before the streamed "
          f"experiment to the peak of its {STREAM_STEPS + 1} steps: "
          f"resident {peak[0] / 2 ** 20:.1f} MiB, of which shared (mapped "
          f"file pages) {peak[1] / 2 ** 20:.1f} MiB, against the train split's "
          f"{on_disk / 2 ** 20:.1f} MiB on disk; {smi}")
    return launches


def write_task_data(tmp: str) -> str:
    """The task phases' data, written without pandas: an ETTh1-shaped CSV
    (17420 hourly rows from 2016-07-01, HUFL ... OT), an SMD-shaped set
    (38 channels, 28479 train and test rows, ~4 % of test rows in
    labelled spike segments) and a synthetic M4 Monthly group (2000
    series of 60-300 points, horizon 18) with its Naive2 file."""
    from sie_tpu_torch.data.synthetic import (write_synthetic_ett,
                                              write_synthetic_m4,
                                              write_synthetic_smd)
    root = os.path.join(tmp, "tasks")
    write_synthetic_ett(os.path.join(root, "ETTh1.csv"), n_rows=17420)
    frac = write_synthetic_smd(root, 28479, 28479, 38, 0.04)
    write_synthetic_m4(os.path.join(root, "m4"), "Monthly", 2000, 60, 300)
    print(f"[tasks] data under {root}: ETTh1 17420 x 7, SMD 28479 + 28479 "
          f"x 38 ({100 * frac:.2f} % of test rows labelled), M4 Monthly "
          f"2000 series")
    return root


def task_config(**kw):
    """run.py's default widths for the tasks (d_model 512, 8 heads, 2
    encoder and 1 decoder layers, d_ff 2048, amp, dropout 0), batch 32,
    lr 1e-4 (TSlib's default for these tasks), weights from seed 0."""
    from sie_tpu_torch.config import Config
    base = dict(model="DNN", d_model=512, n_heads=8, e_layers=2, d_layers=1,
                d_ff=2048, amp=True, dropout=0.0, batch_size=TASK_BATCH,
                lr=1e-4, seed=0, train_epochs=1, freq="h")
    base.update(kw)
    return Config(**base)


def cpu_loss(exp, batch, keep=None) -> float:
    """The experiment's loss on `batch` through the plain CPU path at the
    seed-0 weights (the card model's before its first step)."""
    from sie_tpu_torch.train.tasks import build_task_model
    card = exp.model
    exp.model = build_task_model(exp.cfg, exp.task, torch.Generator(
        ).manual_seed(max(exp.cfg.seed, 0)), exp._marks()).train()
    try:
        with torch.no_grad():
            cpu = tuple(a.cpu() for a in batch)
            loss = (exp._loss(cpu, True) if keep is None else
                    exp._loss(cpu, True, keep=keep.cpu()))
        return float(loss)
    finally:
        exp.model = card


def task_steps(cfg, task: str, want: dict, tag: str, smi: str,
               steps: int = TASK_STEPS) -> dict:
    """`steps` eager steps of `task`'s experiment on the card from the
    seed-0 weights: each checked for `want` launches (none of the other
    kernels), a finite loss and moved weights; the first step's loss
    against the CPU plain path on the same batch (and keep mask); the
    median step and the idle share of 3 more (only when steps > 1). The
    counts are zeroed just before the steps and read just after. Returns
    the launches."""
    from sie_tpu_torch.train.tasks import TASK_EXPERIMENTS
    counts = Counts()
    t_start = time.perf_counter()
    exp = TASK_EXPERIMENTS[task](cfg, device="cuda")
    t_built = time.perf_counter()
    n = len(exp.train_data[0])
    order = torch.from_numpy(np.random.default_rng(0).permutation(n)).cuda()
    batches = [tuple(a[order[i * TASK_BATCH:(i + 1) * TASK_BATCH]]
                     for a in exp.train_data) for i in range(steps + 4)]
    imputing = task == "imputation"
    first = (exp.mask_generator.get_state() if imputing else None)
    params = list(exp.model.parameters())
    expect = Counts.full(want)
    times, losses = [], []
    counts.zero()   # the path's main run
    for i in range(steps):
        before = [p.detach().clone() for p in (params[0], params[-1])]
        c0 = counts.read()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = exp._step(batches[i])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        got = counts.since(c0)
        losses.append(float(loss))
        if got != expect or not np.isfinite(losses[-1]):
            fail(f"{tag} step {i}: launches {got}, want {expect}; loss "
                 f"{losses[-1]}")
        if any(torch.equal(b, p) for b, p in zip(before,
                                                  (params[0], params[-1]))):
            fail(f"{tag} step {i}: the weights did not move")
    launches = counts.read()
    t_steps = time.perf_counter()
    keep = None
    if imputing:   # the first step's keep mask, drawn again
        g = torch.Generator(device="cuda")
        g.set_state(first)
        keep = exp.draw_keep(batches[0][0].shape, g)
    ref = cpu_loss(exp, batches[0], keep)
    if abs(losses[0] - ref) > TASK_LOSS_TOL * abs(ref):
        fail(f"{tag}: first step's loss {losses[0]} on the card, {ref} "
             f"on the CPU plain path")
    t_cpu = time.perf_counter()
    it = iter(batches[steps:])
    if steps == 1:
        idle = "not measured (one step)"
    elif np.median(times) < 200:
        idle = f"{idle_share(lambda: exp._step(next(it)), 3)[1]:.3f}"
    else:
        # TimesNet's eager step is ~25k launches: the profiler takes ~45 s
        # over one (0.909-0.934 over three in an earlier run, PERF.md)
        idle = "not measured"
    print(f"[{tag}] {steps} eager steps (B {TASK_BATCH}): median "
          f"{np.median(times):.3f} ms (idle share {idle}); losses "
          f"{losses[0]:.4f} .. {losses[-1]:.4f}, first "
          f"within {abs(losses[0] - ref) / abs(ref):.2e} of the CPU's "
          f"{ref:.4f}; launches {launches}; s: build {t_built - t_start:.1f}"
          f", steps {t_steps - t_built:.1f}, CPU {t_cpu - t_steps:.1f}, "
          f"profile {time.perf_counter() - t_cpu:.1f}; {smi}")
    del exp
    return launches


FORECAST_BH, FORECAST_T = 256, 336   # (b)'s encoder: 32 rows x 8 heads


def forecast_attention(smi: str) -> None:
    """K5 and K6 at (b)'s encoder shape (BH 256, T 336, dk 64, bf16), at
    rates 0 and 0.1, against attention_plain and attention_bwd_plain at
    K5_TOL / K6_TOL; kernel, plain and (rate 0) SDPA times, and bounds."""
    import torch.nn.functional as F
    from sie_tpu_torch.ops.attention import (attention_bwd,
                                             attention_bwd_plain,
                                             attention_fwd, attention_plain)
    bh, t, dk, dt = FORECAST_BH, FORECAST_T, 64, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(31)
    q, k, v, do = (torch.randn((bh, t, dk), generator=gen, device="cuda")
                   .to(dt) for _ in range(4))
    scale, seed = 1.0 / dk ** 0.5, 4321
    elem = bh * t * dk * 2   # bytes of one (BH, T, dk) bf16 tensor
    b5 = bound_ms(4 * elem + 4 * bh * t, 4 * bh * t * t * dk, PEAK_BF16)
    b6 = bound_ms(8 * elem + 4 * bh * t, 10 * bh * t * t * dk, PEAK_BF16)
    for rate in (0.0, RATE):
        o, lse = attention_fwd(q, k, v, scale, rate, seed, want_lse=True)
        e5 = float((o.float() - attention_plain(
            q, k, v, scale, rate, seed).float()).abs().max())
        bwd = lambda: attention_bwd(q, k, v, o, do, lse, scale, rate, seed)
        e6 = []
        for got, w in zip(bwd(), attention_bwd_plain(q, k, v, do, scale,
                                                     rate, seed)):
            scl = float(w.float().abs().max())
            e6.append(float((got.float() - w.float()).abs().max()) / scl)
        if not e5 <= K5_TOL[dt] or not max(e6) <= K6_TOL[dt]:
            fail(f"K5/K6 at BH {bh}, T {t}, rate {rate}: K5 max abs err "
                 f"{e5} (limit {K5_TOL[dt]}), K6 dq/dk/dv {e6} x max|want| "
                 f"(limit {K6_TOL[dt]})")
        ms5 = events_ms(lambda: attention_fwd(q, k, v, scale, rate, seed,
                                              want_lse=True), reps=20)
        ms6 = events_ms(bwd, reps=20)
        plain5 = events_ms(lambda: attention_plain(q, k, v, scale, rate,
                                                   seed), reps=5)
        plain6 = events_ms(lambda: attention_bwd_plain(
            q, k, v, do, scale, rate, seed), reps=5)
        lib = ""
        if rate == 0.0:
            q4, k4, v4 = (z.view(bh // 8, 8, t, dk).detach().requires_grad_()
                          for z in (q, k, v))
            out4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
            lib5 = events_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, scale=scale), reps=20)
            lib6 = events_ms(lambda: torch.autograd.grad(
                out4, (q4, k4, v4), do.view(bh // 8, 8, t, dk),
                retain_graph=True), reps=20)
            lib = f"; sdpa {lib5:.4f} / backward {lib6:.4f}"
            del q4, k4, v4, out4
        print(f"[tasks/attention] BH {bh}, T {t}, dk {dk}, bf16, rate "
              f"{rate} ({smi}): K5 {ms5:.4f} ms, K6 {ms6:.4f} ms; plain "
              f"{plain5:.4f} / {plain6:.4f}{lib}; bound K5 {b5[0]:.4f} "
              f"({b5[1]}), K6 {b6[0]:.4f} ({b6[1]}); max abs err K5 "
              f"{e5:.3e} (limit {K5_TOL[dt]}), K6 dq/dk/dv "
              + "/".join(f"{e:.2e}" for e in e6)
              + f" x max|want| (limit {K6_TOL[dt]})")
        del o, lse
    del q, k, v, do


def phase_tasks(tmp: str, smi: str) -> dict:
    """The task models at run.py's default widths (TimesNet at 32/32, top_k
    5, 6 kernels): (a) long-term forecasting on ETTh1 at seq_len 96, (b)
    the Transformer at seq_len 336 (K5 2, K6 2 a step; then K5 and K6 at
    its encoder's shape against their plain versions), (c) imputation,
    (d) anomaly detection on SMD, (e) short-term forecasting on M4
    Monthly. Returns (b)'s launches."""
    root = write_task_data(tmp)
    timesnet = dict(d_model=32, d_ff=32, top_k=5, num_kernels=6)
    width = lambda dnn: timesnet if dnn == "TimesNet" else {}
    ett = dict(data="ETTh1", dataset="ETTh1", data_root=root, seq_len=96,
               label_len=48, pred_len=96)
    for dnn in ("Transformer", "TimesNet", "PatchTST"):
        task_steps(task_config(dnn_type=dnn, **ett, **width(dnn)),
                   "long_term_forecast", {}, f"tasks/forecast {dnn}", smi)
    long = task_steps(task_config(dnn_type="Transformer",
                                  **dict(ett, seq_len=336)),
                      "long_term_forecast", {"K5": 2, "K6": 2},
                      "tasks/forecast Transformer seq_len 336", smi)
    forecast_attention(smi)
    for dnn in ("Transformer", "TimesNet", "PatchTST"):
        task_steps(task_config(dnn_type=dnn, mask_rate=0.25, **ett,
                               **width(dnn)),
                   "imputation", {}, f"tasks/imputation {dnn}", smi)
    smd = dict(data="SMD", data_root=root, seq_len=100, anomaly_ratio=0.5)
    for dnn in ("Transformer", "TimesNet", "PatchTST"):
        task_steps(task_config(dnn_type=dnn, **smd, **width(dnn)),
                   "anomaly_detection", {}, f"tasks/anomaly {dnn}", smi)
    m4 = dict(data="m4", data_root=os.path.join(root, "m4"),
              seasonal_patterns="Monthly", seq_len=36)
    for dnn in ("Transformer", "TimesNet"):
        task_steps(task_config(dnn_type=dnn, **m4, **width(dnn)),
                   "short_term_forecast", {}, f"tasks/m4 {dnn}", smi)
    return long


def phase_task_cli(tmp: str) -> None:
    """The four tasks through `python -m sie_tpu_torch.run`'s main, 1 epoch
    each at run.py's default widths: the pickle, M4's forecast CSV read
    back by the port's M4Summary against the Naive2 file, and the
    anomaly metrics."""
    from sie_tpu_torch.utils.m4_summary import M4Summary
    root = os.path.join(tmp, "tasks")
    result = os.path.join(tmp, "task_result")
    common = ["--train_epochs", "1", "--batch_size", str(TASK_BATCH),
              "--lr", "1e-4", "--seed", "0", "--model", "DNN",
              "--result_dir", result,
              "--checkpoint_dir", os.path.join(tmp, "task_ck"),
              "--cache_dir", os.path.join(tmp, "cache")]
    runs = {
        "long_term_forecast": ["--data", "ETTh1", "--dataset", "ETTh1",
                               "--data_root", root],
        "short_term_forecast": ["--data", "m4", "--data_root",
                                os.path.join(root, "m4"),
                                "--seasonal_patterns", "Monthly",
                                "--seq_len", "36"],
        "imputation": ["--data", "ETTh1", "--dataset", "ETTh1",
                       "--data_root", root],
        "anomaly_detection": ["--data", "SMD", "--data_root", root,
                              "--seq_len", "100", "--anomaly_ratio", "0.5"]}
    for task, flags in runs.items():
        t0 = time.perf_counter()
        text, res = run_cli(common + ["--task_name", task] + flags)
        metrics = res[0][2]
        pkl = os.path.join(result, "DNN", f"{task}_seed0.pkl")
        if not os.path.exists(pkl) or not all(
                np.isfinite(v) for v in metrics.values()):
            fail(f"{task} through the CLI: {metrics}, pickle {pkl}")
        if task == "anomaly_detection" and not all(
                k in metrics for k in ("precision", "recall", "f1")):
            fail(f"the anomaly run printed {metrics}")
        extra = ""
        if task == "short_term_forecast":
            smape, owa, _, _ = M4Summary(os.path.join(result, "DNN"),
                                         os.path.join(root, "m4")).evaluate()
            if not np.isfinite(owa["Average"]):
                fail(f"M4Summary: sMAPE {smape}, OWA {owa}")
            extra = f"; M4Summary sMAPE {smape}, OWA {owa}"
        print(f"[task_cli] {task}: {time.perf_counter() - t0:.1f} s, "
              + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
              + extra)


def phase_stream_and_tasks(tmp: str, smi: str) -> tuple:
    """Phases 30-32 under one time limit -> (the streamed run's launches,
    the seq_len 336 forecaster's)."""
    t0 = time.perf_counter()
    streamed = phase_stream(tmp, smi)
    t1 = time.perf_counter()
    long = phase_tasks(tmp, smi)
    t2 = time.perf_counter()
    phase_task_cli(tmp)
    print(f"[tasks] phases 30-32: {t1 - t0:.1f} + {t2 - t1:.1f} + "
          f"{time.perf_counter() - t2:.1f} s")
    return streamed, long


MOE = dict(moe_experts=8, moe_top_k=1, moe_capacity_factor=1.25,
           moe_aux_weight=0.01)   # scripts/onchip_cert.py:101-106's MoE
MOE_CHECK_STEPS = 4     # eager steps against graph steps, bit for bit
MOE_TIMED = 10          # replays timed (after warm-up, capture, a replay)
MOE_TOP2_B = 16
VARIANT_STEPS = 3       # eager steps of each attention variant
EXTRA_FAMILIES = ("Autoformer", "FEDformer", "ETSformer", "Pyraformer",
                  "Crossformer")
EXTRA_STEPS = 5         # staged steps of each expert: warm-up, capture, 3
EXTRA_B = 16
LOSS_TOL = 5e-2         # first loss, card vs CPU plain path, relative


def moe_config(**kw):
    """The flagship (phase 9's training settings) with a Switch-MoE FFN in
    each encoder layer: 8 experts, top-1, capacity factor 1.25, aux weight
    0.01, dropout 0.1."""
    return train_config(dropout=RATE, **dict(MOE, **kw))


def loss_and_grads(cfg, model, device, batch) -> tuple:
    """(the training loss, with the layers' aux losses, and every
    parameter's gradient on the host in float32) of `model` on `batch`."""
    from sie_tpu_torch.train.trainer import Trainer
    t = Trainer(cfg, 1, model=model, device=device)
    loss, _ = t.loss_fn(t.model, t._device_batch(batch), 1.0, None)
    loss.backward()
    return float(loss.detach()), {k: p.grad.float().cpu()
                         for k, p in t.model.named_parameters()}


def loss_only(cfg, model, device, batch) -> float:
    """The training-mode loss (aux losses included) of `model` on
    `batch`, without a backward pass."""
    from sie_tpu_torch.train.trainer import Trainer
    t = Trainer(cfg, 1, model=model, device=device)
    return float(t.loss_fn(t.model, t._device_batch(batch), 1.0, None)[0])


def against_cpu(cfg, ds, tag: str, grads: bool) -> None:
    """The seed-0 weights' first training loss on 2 rows (aux losses
    included) on the card against the CPU plain path, within LOSS_TOL
    relative; with `grads`, every parameter's gradient within GRAD_TOL
    (relative norm). Dropout 0: the two paths draw no masks."""
    from sie_tpu_torch.models.registry import build_model
    cfg0 = cfg.replace(dropout=0.0)
    fresh = build_model(cfg0, "cuda", torch.Generator().manual_seed(0))
    cpu = copy.deepcopy(fresh).cpu()
    batch = (ds.x[:2], ds.y[:2], ds.padding_mask[:2], np.ones(2, np.float32))
    if grads:
        got, gg = loss_and_grads(cfg0, fresh, "cuda", batch)
        want, gw = loss_and_grads(cfg0, cpu, "cpu", batch)
    else:
        with torch.no_grad():
            got, want = (loss_only(cfg0, m, d, batch)
                         for m, d in ((fresh, "cuda"), (cpu, "cpu")))
    err = abs(got - want) / abs(want)
    if not err <= LOSS_TOL:
        fail(f"{tag}: first loss {got} on the card, {want} on the CPU")
    extra = ""
    if grads:
        worst = worst_gradient(gg, gw, f"{tag} card vs CPU")
        extra = f"; worst gradient {worst[1]:.3e} ({worst[0]})"
    print(f"[{tag}] card vs CPU plain path, 2 rows: loss {got:.6f} vs "
          f"{want:.6f} ({err:.2e} relative){extra}")


def replay_ms(cfg, ds, sched, tag: str) -> tuple:
    """Median ms and idle share of MOE_TIMED replays of the staged step
    (after its eager warm-up, capture and one replay)."""
    t = seed0_trainer(cfg)
    dev = t.device_data("train", ds)
    staged = t.stage_steps(sched, 1.0)
    for k in range(3):
        t.train_step_staged(dev, staged, k % len(sched))
    it = iter(range(10 ** 6))
    step = lambda: t.train_step_staged(dev, staged, next(it) % len(sched))
    times = timed(step, MOE_TIMED)
    _, idle = idle_share(step, 3)
    print(f"[{tag}] {MOE_TIMED} replays (B={cfg.batch_size}): "
          + ", ".join(f"{v:.3f}" for v in times)
          + f"; median {np.median(times):.3f} ms, idle share {idle:.3f}")
    return float(np.median(times)), idle


def phase_moe(smi: str) -> dict:
    """(a) The flagship with a Switch-MoE FFN at full width: eager steps
    against the captured staged steps, bit for bit, K1 6, K2 6, K5 2, K6 2
    a step (counts zeroed just before, read just after); replays' median
    and idle share beside the dense flagship's; the first loss (with the
    aux term) and the gradients against the CPU plain path; 64 rows
    served, 4 of them against the CPU; one top-2 step at B 16."""
    from sie_tpu_torch.serve import Predictor
    from sie_tpu_torch.train.trainer import Trainer
    cfg = moe_config()
    ds = random_rows(cfg, 4 * cfg.batch_size)
    sched = schedule(cfg, len(ds.y), MOE_CHECK_STEPS)
    counts = Counts()
    counts.zero()   # the path's main run
    eager, _, _ = graph_against_eager(cfg, ds, sched, MOE_CHECK_STEPS,
                                      TRAIN_WANT, "moe", True, stats=False)
    launches = counts.read()
    print(f"[moe] launches over the run {launches}")
    moe_ms, moe_idle = replay_ms(cfg, ds, sched, "moe")
    dense_ms, dense_idle = replay_ms(train_config(dropout=RATE), ds, sched,
                                     "moe/dense")
    print(f"[moe] replayed step: MoE {moe_ms:.3f} ms (idle {moe_idle:.3f})"
          f" against dense {dense_ms:.3f} ms (idle {dense_idle:.3f}), "
          f"+{moe_ms - dense_ms:.3f} ms; {smi}")
    against_cpu(cfg, ds, "moe", grads=True)
    # the seed-0 weights: after 4 steps at lr 5e-3 the flatten head
    # saturates, and card and CPU logits would agree for that alone
    fresh = seed0_trainer(cfg).model
    pred = Predictor.from_module(cfg, fresh, device="cuda", max_batch=64)
    x = ds.x[:64]
    c0 = counts.read()
    t0 = time.perf_counter()
    out = pred.predict(x)
    ms = 1e3 * (time.perf_counter() - t0)
    got = counts.since(c0)
    if got != Counts.full({"K1": 6, "K5": 2}) or \
            out.logits.shape != (64, 3) or not np.isfinite(out.logits).all():
        fail(f"moe: a 64-row request launched {got}, logits "
             f"{out.logits.shape}")
    cpu = Predictor.from_module(cfg, copy.deepcopy(fresh).cpu(),
                                device="cpu", max_batch=64)
    e = float(np.abs(out.logits[:4] - cpu.predict(x[:4]).logits).max())
    if not e <= SERVE_TOL:
        fail(f"moe: served logits differ from the CPU plain path by {e}")
    print(f"[moe] 64 rows served in {ms:.3f} ms, launches {got}; rows 0-3 "
          f"against the CPU plain path: max |dlogits| {e:.3e}")
    top2 = cfg.replace(moe_top_k=2, batch_size=MOE_TOP2_B)
    t = Trainer(top2, 1, device="cuda",
                generator=torch.Generator().manual_seed(0))
    dev = t.device_data("train", ds)
    c0 = counts.read()
    loss, _ = t.train_step_indexed(dev, np.arange(MOE_TOP2_B),
                                   np.ones(MOE_TOP2_B, np.float32), 1.0)
    got = counts.since(c0)
    if got != Counts.full(TRAIN_WANT) or not np.isfinite(float(loss)):
        fail(f"moe top-2 step: launches {got}, loss {float(loss)}")
    print(f"[moe] top-2 step at B {MOE_TOP2_B}: loss {float(loss):.4f}, "
          f"launches {got}")
    return launches


LSH_FLIP_MAX = 1e-3   # share of bf16 buckets that may differ, card vs CPU
LSH_ROWS = 4


def lsh_amp_against_cpu(cfg, ds) -> None:
    """The seed-0 lsh model's first attention layer under amp, card
    against the CPU plain path, on the CPU's embedding of LSH_ROWS rows:
    fails if more than LSH_FLIP_MAX of its (row, head, round, position)
    buckets differ, or if at the rows whose buckets all agree its output
    is not within SERVE_TOL + 1/128 of the CPU's (a row with a
    flipped bucket sorts, and so attends, otherwise: a discrete jump).
    Prints the whole model's eval logits gap, which such jumps move."""
    t = seed0_trainer(cfg)
    cpu = copy.deepcopy(t.model).cpu().eval()
    x, mask = ds.x[:LSH_ROWS], ds.padding_mask[:LSH_ROWS]
    got, _ = t.eval_step((x, ds.y[:LSH_ROWS], mask,
                          np.ones(LSH_ROWS, np.float32)))
    t.model.eval()
    card = t.model.deep_model.encoder.layers[0].attention
    host = cpu.deep_model.encoder.layers[0].attention
    with torch.no_grad():
        want, _ = cpu(torch.from_numpy(x), torch.from_numpy(mask))
        enc = cpu.deep_model.enc_embedding(
            torch.from_numpy(x).to(cfg.compute_dtype))
        flips = card.buckets_of(enc.cuda()).cpu() != host.buckets_of(enc)
        out, ref = card(enc.cuda()).float().cpu(), host(enc).float()
    clean = ~flips.reshape(LSH_ROWS, -1).any(-1)
    share = float(flips.float().mean())
    err = (out - ref).abs()[clean]
    over = err > SERVE_TOL + ref.abs()[clean] / 128
    if not share <= LSH_FLIP_MAX or not bool(clean.any()) or \
            bool(over.any()):
        fail(f"variants/lsh amp: {100 * share:.4f} % of the first layer's "
             f"buckets differ (limit {100 * LSH_FLIP_MAX} %); rows without "
             f"a flip {clean.tolist()}, {int(over.sum())} outputs there "
             f"beyond {SERVE_TOL} + 1/128 relative")
    e = float((got.float().cpu() - want).abs().max())
    print(f"[variants/lsh] amp, first layer, {LSH_ROWS} rows: "
          f"{100 * share:.4f} % of buckets differ (limit "
          f"{100 * LSH_FLIP_MAX} %); at the {int(clean.sum())} rows without "
          f"a flip max |dout| {float(err.max()):.3e} (max |out| "
          f"{float(ref.abs().max()):.3f}); the model's eval logits card vs "
          f"CPU max |dlogits| {e:.3e}")


def phase_variants(smi: str) -> dict:
    """(b) The attention variants ds, prob and lsh in the flagship encoder
    (dropout 0.1): VARIANT_STEPS eager steps each, K1 6 and K2 6 a step and
    no K5/K6; the seed-0 weights' eval logits of 2 rows against the CPU
    plain path. Returns the launches over the three runs."""
    total = Counts.full({})
    for variant in ("ds", "prob", "lsh"):
        cfg = train_config(dropout=RATE, attention_variant=variant)
        ds = random_rows(cfg, 2 * cfg.batch_size)
        # the lsh layer's shared query-key projection is `qk`
        watch = tuple(w.replace(".query.", ".qk.") if variant == "lsh"
                      else w for w in WATCH)
        trainer, *_, launches = train_steps(cfg, ds, SBM_WANT, 0,
                                            VARIANT_STEPS,
                                            f"variants/{variant}", watch)
        total = {k: total[k] + launches[k] for k in total}
        if variant == "lsh":
            # bf16 keys round differently on the card and the CPU, and a
            # key near a rotation's tie changes bucket (a discrete jump):
            # under amp the buckets and the first layer's unflipped rows
            # are held, the logits at 5e-2 in f32
            lsh_amp_against_cpu(cfg, ds)
            cfg_eval = cfg.replace(amp=False)
        else:
            cfg_eval = cfg
        eval_against_cpu(seed0_trainer(cfg_eval), ds, 2, SERVE_TOL,
                         f"variants/{variant}")
        del trainer
    print(f"[variants] launches over the three runs {total}; {smi}")
    return total


def extra_config(family: str):
    """InterpGN with an extra family as the expert at the configuration
    the repo runs them in (scripts/onchip_cert.py:142-146): the CHISCO
    shape, d_model 128, d_ff 256, 8 heads, 2 layers, 10 shapelets a bank,
    B 16, dropout 0.1, amp (the family itself runs in f32, as in the JAX
    package); c_out = enc_in, which ETSformer's level needs."""
    return train_config(dnn_type=family, d_model=128, d_ff=256, n_heads=8,
                        e_layers=2, dropout=RATE, c_out=122).replace(
                            batch_size=EXTRA_B)


# The parameters that the InterpGN training loss leaves unread with each
# family as the expert (2 layers), as the JAX package's models do:
# FEDformer's Fourier self-attention reads only its queries, ETSformer's
# classifier reads neither its level nor its last layer's residual stream,
# and Crossformer's dimension receiver attends over `factor` = 1 router
# vector, where the softmax is 1 whatever its query and key. Their
# gradients are exactly zero in the JAX package, which
# tests/test_torch_port_extra_models.py holds this table to.
_ENC = "deep_model.rep.encoder.layers."
_WB = ("weight", "bias")
UNREAD = {
    "Autoformer": frozenset(),
    "FEDformer": frozenset(f"{_ENC}{i}.attention.{p}.{w}" for i in (0, 1)
                           for p in ("key", "value") for w in _WB),
    "ETSformer": frozenset(
        [f"{_ENC}{i}.level.{m}.{w}" for i in (0, 1)
         for m in ("growth_pred", "season_pred") for w in _WB]
        + [f"{_ENC}{i}.level.es.{p}" for i in (0, 1)
           for p in ("smoothing_weight", "v0")]
        + [f"{_ENC}1.{m}.weight" for m in ("ff1", "ff2")]
        + [f"{_ENC}1.norm{i}.{w}" for i in (1, 2) for w in _WB]),
    "Pyraformer": frozenset(),
    "Crossformer": frozenset(
        f"deep_model.scales.encoder.block_{i}.encode_layer_0.dim_receiver."
        f"{p}.{w}" for i in (0, 1) for p in ("query", "key") for w in _WB),
}


def unread_params(cfg, ds) -> frozenset:
    """The parameters whose gradient the training loss (2 rows, dropout 0)
    leaves at none or exactly zero on the card."""
    from sie_tpu_torch.models.registry import build_model
    from sie_tpu_torch.train.trainer import Trainer
    model = build_model(cfg.replace(dropout=0.0), "cuda",
                        torch.Generator().manual_seed(0))
    t = Trainer(cfg.replace(dropout=0.0), 1, model=model, device="cuda")
    batch = t._device_batch((ds.x[:2], ds.y[:2], ds.padding_mask[:2],
                             np.ones(2, np.float32)))
    loss, _ = t.loss_fn(t.model, batch, 1.0, None)
    names, params = zip(*t.model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return frozenset(n for n, g in zip(names, grads)
                     if g is None or not bool(g.any()))


def phase_extra_experts(smi: str) -> dict:
    """(c) InterpGN with each family as its expert: the parameters that
    the loss leaves without a gradient on the card are UNREAD's; eager
    steps against EXTRA_STEPS staged ones (warm-up, capture, replays), bit
    for bit, K1 6 and K2 6 a step, every parameter but UNREAD's moved; the
    first loss against the CPU plain path; a 16-row request. Returns the
    launches over the five runs."""
    from sie_tpu_torch.serve import Predictor
    counts = Counts()
    total = Counts.full({})
    for family in EXTRA_FAMILIES:
        t0 = time.perf_counter()
        cfg = extra_config(family)
        ds = random_rows(cfg, 4 * cfg.batch_size)
        sched = schedule(cfg, len(ds.y), EXTRA_STEPS)
        unread = unread_params(cfg, ds)
        if unread != UNREAD[family]:
            fail(f"extra/{family}: the loss leaves {sorted(unread)} unread "
                 f"on the card, the JAX package {sorted(UNREAD[family])}")
        print(f"[extra/{family}] {len(unread)} parameters without a "
              f"gradient, as in the JAX package")
        counts.zero()   # the path's main run
        eager, med, _ = graph_against_eager(
            cfg, ds, sched, EXTRA_STEPS, SBM_WANT, f"extra/{family}", True,
            stats=False, unused=UNREAD[family])
        launches = counts.read()
        total = {k: total[k] + launches[k] for k in total}
        against_cpu(cfg, ds, f"extra/{family}", grads=False)
        out = Predictor.from_module(cfg, eager.model, device="cuda",
                                    max_batch=64).predict(ds.x[:16])
        if out.logits.shape != (16, 3) or not np.isfinite(out.logits).all():
            fail(f"extra/{family}: 16-row request gave {out.logits.shape}")
        print(f"[extra/{family}] replays bit-equal to eager; "
              f"16-row request ok; {time.perf_counter() - t0:.1f} s; "
              f"launches {launches}; {smi}")
        del eager
    return total


EXTRA_TASK_STEPS = 5


def phase_extra_tasks(tmp: str, smi: str) -> None:
    """(d) The five forecasters at phase 31 (a)'s settings (ETTh1 shape,
    seq_len 96, label 48, pred 96, run.py's default widths, B 32): 5 eager
    steps each; one imputation and one anomaly step of each dense head;
    one CLI run of --dnn_type FEDformer on the forecast task for 1
    epoch. No kernel is launched on these paths."""
    root = os.path.join(tmp, "tasks")
    if not os.path.isdir(root):
        write_task_data(tmp)
    ett = dict(data="ETTh1", dataset="ETTh1", data_root=root, seq_len=96,
               label_len=48, pred_len=96)
    smd = dict(data="SMD", data_root=root, seq_len=100, anomaly_ratio=0.5)
    for fam in EXTRA_FAMILIES:
        task_steps(task_config(dnn_type=fam, **ett), "long_term_forecast",
                   {}, f"extra_tasks/forecast {fam}", smi, EXTRA_TASK_STEPS)
        task_steps(task_config(dnn_type=fam, mask_rate=0.25, **ett),
                   "imputation", {}, f"extra_tasks/imputation {fam}", smi, 1)
        task_steps(task_config(dnn_type=fam, **smd), "anomaly_detection", {},
                   f"extra_tasks/anomaly {fam}", smi, 1)
    t0 = time.perf_counter()
    result = os.path.join(tmp, "extra_result")
    _, res = run_cli(["--task_name", "long_term_forecast", "--data", "ETTh1",
                      "--dataset", "ETTh1", "--data_root", root, "--model",
                      "DNN", "--dnn_type", "FEDformer", "--train_epochs",
                      "1", "--batch_size", str(TASK_BATCH), "--lr", "1e-4",
                      "--seed", "0", "--result_dir", result,
                      "--checkpoint_dir", os.path.join(tmp, "extra_ck"),
                      "--cache_dir", os.path.join(tmp, "cache")])
    metrics = res[0][2]
    pkl = os.path.join(result, "DNN", "long_term_forecast_seed0.pkl")
    if not os.path.exists(pkl) or not all(np.isfinite(v)
                                          for v in metrics.values()):
        fail(f"FEDformer forecast through the CLI: {metrics}")
    print(f"[extra_tasks] FEDformer through the CLI, 1 epoch: "
          f"{time.perf_counter() - t0:.1f} s, " + ", ".join(
              f"{k} {v:.4f}" for k, v in metrics.items()))


def phase_extra(tmp: str, smi: str) -> tuple:
    """Phases 33-36 under one time limit -> the launches of (a), (b) and
    (c)."""
    t = [time.perf_counter()]
    moe = phase_moe(smi)
    t.append(time.perf_counter())
    variants = phase_variants(smi)
    t.append(time.perf_counter())
    experts = phase_extra_experts(smi)
    t.append(time.perf_counter())
    phase_extra_tasks(tmp, smi)
    t.append(time.perf_counter())
    print("[extra] phases 33-36: " + " + ".join(
        f"{b - a:.1f}" for a, b in zip(t, t[1:])) + " s")
    return moe, variants, experts


# ---- phases 37-38: the multi-seed ensemble ---------------------------------
ENS_SEEDS = (0, 42, 1234, 8237, 2023)   # DEFAULT_SEEDS, run.py's five seeds
ENS_ROWS = 640          # numpy-seeded rows held on the card
ENS_CHECK = 5           # steps held against lone replays, bit for bit
ENS_WARMUP, ENS_TIMED = 3, 10
ENS_STOP_SEED, ENS_STOP_STEP = 42, 3
ENS_WANT = {"K1": 30, "K2": 30, "K5": 10, "K6": 10}   # 5 x a flagship step
UEA_ENS_WANT = {"K1": 30, "K2": 30}   # 5 x six stride-1 banks, FCN expert
SCP2 = dict(n_train=200, n_test=180, n_dims=7, length=1152, n_classes=2)
SWEEP_EPOCHS, SWEEP_PATIENCE = 6, 2   # run_uea.sh's 500 and 50, cut
SCP2_NOISE = 4.0        # the series' noise, against sines of amplitude 1


def ens_schedules(n_rows: int, b: int, seeds) -> list:
    """Each seed's schedule of one epoch over n_rows: its own permutation
    (np.random.default_rng(seed + 100)) in batches of b."""
    out = []
    for s in seeds:
        order = np.random.default_rng(s + 100).permutation(n_rows)
        out.append([(order[i * b:(i + 1) * b], np.ones(b, np.float32))
                    for i in range(n_rows // b)])
    return out


def moved_state(trainer) -> list:
    """Copies of what a train step moves: parameters, Adam's moments and
    step counts, and the optimizer count."""
    opt = trainer.optimizer
    return ([p.detach().clone() for p in opt.params]
            + [opt.adam.state[p][k].clone() for p in opt.params
               for k in ("exp_avg", "exp_avg_sq", "step")]
            + [opt.count_t.clone()])


def peak_mb(since: int) -> float:
    return (torch.cuda.max_memory_allocated() - since) / 2 ** 20


def lone_replays(cfg, seed: int, ds, sched, steps: int, timed_n: int):
    """Seed `seed`'s lone trainer over its schedule: the losses of `steps`
    staged steps (warm-up, capture, replays), then `timed_n` timed replays
    -> (trainer, losses, replay ms)."""
    from sie_tpu_torch.train.trainer import Trainer
    t = Trainer(cfg.replace(seed=seed), len(sched), device="cuda",
                generator=torch.Generator().manual_seed(max(seed, 0)))
    dev = t.device_data("train", ds)
    staged = t.stage_steps(sched, 1.0)
    losses = [t.train_step_staged(dev, staged, k)[0] for k in range(steps)]
    state = moved_state(t)
    it = iter(range(steps, 10 ** 6))
    ms = timed(lambda: t.train_step_staged(dev, staged,
                                           next(it) % len(sched)), timed_n)
    return state, losses, ms


def phase_ensemble(smi: str) -> dict:
    """(a) The flagship ensemble at full width: five seeds (DEFAULT_SEEDS)
    trained as one captured step, each on its own schedule over ENS_ROWS
    numpy-seeded rows held on the card, dropout RATE. Each step's warm-up
    and capture launch K1 30, K2 30, K5 10, K6 10 and a replay nothing;
    after ENS_CHECK steps every seed's losses, parameters and Adam state
    equal a lone Trainer's graph replays of that seed, bit for bit; the
    median of ENS_TIMED replays and the idle share beside the sum of the
    lone replays' medians, and the peak memory of 5 seeds and of 1; a
    second ensemble with seed ENS_STOP_SEED stopped at step ENS_STOP_STEP:
    its state frozen, the others moving, no new capture. Returns the
    launches counted over the ensemble's steps."""
    from sie_tpu_torch.train.ensemble import EnsembleTrainer
    cfg = train_config(dropout=RATE)
    ds = random_rows(cfg, ENS_ROWS)
    scheds = ens_schedules(ENS_ROWS, cfg.batch_size, ENS_SEEDS)
    counts = Counts()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counts.zero()   # the path's main run
    et = EnsembleTrainer(cfg, len(scheds[0]), ENS_SEEDS, device="cuda")
    dev = et.device_data("train", ds)
    staged = et.stage_steps(scheds, 1.0)
    expect, none = Counts.full(ENS_WANT), Counts.full({})
    losses = []
    for k in range(ENS_CHECK):
        c0 = counts.read()
        loss, logits = et.train_step_staged(dev, staged, k)
        got = counts.since(c0)
        if got != (expect if k < 2 else none) or \
                not torch.isfinite(loss).all() or \
                logits.shape != (len(ENS_SEEDS), cfg.batch_size,
                                 cfg.num_class):
            fail(f"ensemble step {k}: launches {got}, losses {loss}")
        losses.append(loss)
    launches = counts.read()
    torch.cuda.synchronize()
    peak5 = peak_mb(base)
    if len(et.captures) != 1:
        fail(f"ensemble: {len(et.captures)} graphs captured, want 1")
    lone_ms = []
    peak1 = None
    for i, s in enumerate(ENS_SEEDS):
        torch.cuda.synchronize()
        base1 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state, lone_losses, ms = lone_replays(cfg, s, ds, scheds[i],
                                              ENS_CHECK, ENS_TIMED)
        if peak1 is None:
            torch.cuda.synchronize()
            peak1 = peak_mb(base1)
        lone_ms.append(float(np.median(ms)))
        same = all(torch.equal(a, b[i]) for a, b in zip(lone_losses, losses))
        same = same and all(torch.equal(a, b) for a, b in zip(
            state, moved_state(et.trainers[i])))
        if not same:
            fail(f"ensemble seed {s}: losses or state after {ENS_CHECK} "
                 f"steps differ from its lone replays")
        del state, lone_losses
        torch.cuda.empty_cache()
    print(f"[ensemble] {ENS_CHECK} steps of {len(ENS_SEEDS)} seeds: "
          f"launches {launches} (warm-up and capture, replays none); "
          f"every seed's losses, parameters and Adam state bit-equal to "
          f"its lone replays; losses at step {ENS_CHECK - 1}: "
          f"{[round(float(v), 6) for v in losses[-1]]}")
    it = iter(range(ENS_CHECK, 10 ** 6))
    step = lambda: et.train_step_staged(dev, staged,
                                        next(it) % len(scheds[0]))
    for _ in range(ENS_WARMUP):
        step()
    times = timed(step, ENS_TIMED)
    _, idle = idle_share(step, 3)
    ens_ms = float(np.median(times))
    print(f"[ensemble] {ENS_TIMED} replays of the 5-seed step (B="
          f"{cfg.batch_size} a seed): " + ", ".join(f"{v:.3f}" for v in times)
          + f"; median {ens_ms:.3f} ms, idle share {idle:.4f}; lone "
          f"replays' medians {[round(v, 3) for v in lone_ms]}, sum "
          f"{sum(lone_ms):.3f} ms; ratio {ens_ms / sum(lone_ms):.4f}; {smi}")
    print(f"[ensemble] peak memory above the data: 5 seeds {peak5:.1f} MiB"
          f", 1 seed {peak1:.1f} MiB; {smi}")
    del et, dev, staged, losses
    torch.cuda.empty_cache()
    # a seed stopped at ENS_STOP_STEP: frozen, the others moving, one graph
    et = EnsembleTrainer(cfg, len(scheds[0]), ENS_SEEDS, device="cuda")
    dev = et.device_data("train", ds)
    staged = et.stage_steps(scheds, 1.0)
    alive = np.ones(len(ENS_SEEDS), np.float32)
    stop = ENS_SEEDS.index(ENS_STOP_SEED)
    for k in range(ENS_CHECK + 1):
        if k == ENS_STOP_STEP:
            alive[stop] = 0.0
            before = [moved_state(t) for t in et.trainers]
        et.train_step_staged(dev, staged, k, alive)
    after = [moved_state(t) for t in et.trainers]
    frozen = all(torch.equal(a, b) for a, b in zip(before[stop],
                                                   after[stop]))
    moving = [i for i in range(len(ENS_SEEDS)) if i != stop and not any(
        torch.equal(a, b) for a, b in zip(before[i][:1], after[i][:1]))]
    count = et.trainers[stop].optimizer.count
    if not frozen or len(moving) != len(ENS_SEEDS) - 1 or \
            len(et.captures) != 1 or count != ENS_STOP_STEP:
        fail(f"ensemble alive: seed {ENS_STOP_SEED} frozen {frozen}, "
             f"moving seeds {moving}, count {count}, {len(et.captures)} "
             f"graphs")
    print(f"[ensemble] seed {ENS_STOP_SEED} stopped at step "
          f"{ENS_STOP_STEP}: parameters, moments and count ({count}) "
          f"frozen over {ENS_CHECK + 1 - ENS_STOP_STEP} steps, the other "
          f"{len(moving)} seeds moved, {len(et.captures)} graph captured")
    del et, dev, staged, before, after
    torch.cuda.empty_cache()
    return launches


def add_noise(path: str, sigma: float, seed: int) -> None:
    """Adds noise of deviation `sigma` from np.random.default_rng(seed) to
    every value of a .ts file: the synthetic classes separate at the first
    epoch (validation accuracy 1, and a tie resets the patience), as
    SelfRegulationSCP2's do not."""
    rng = np.random.default_rng(seed)
    with open(path) as f:
        lines = f.read().splitlines()
    start = next(i for i, l in enumerate(lines) if l.startswith("@data")) + 1
    for i in range(start, len(lines)):
        *dims, label = lines[i].split(":")
        noisy = []
        for d in dims:
            v = np.array(d.split(","), np.float64)
            v += rng.normal(0.0, sigma, v.shape)
            noisy.append(",".join(f"{x:.6f}" for x in v))
        lines[i] = ":".join(noisy + [label])
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def sweep_argv(root: str, tmp: str, datasets) -> list:
    """run_uea.sh's flags through the port's sweep script, its epochs and
    patience cut to SWEEP_EPOCHS and SWEEP_PATIENCE."""
    return ["--data", "UEA", "--data_root", root, "--datasets", *datasets,
            "--model", "InterpGN", "--dnn_type", "FCN", "--num_shapelet",
            "10", "--lambda_div", "0.1", "--lambda_reg", "0.1", "--epsilon",
            "1", "--gating_value", "1", "--batch_size", "32", "--lr", "5e-3",
            "--no-amp", "--train_epochs", str(SWEEP_EPOCHS), "--patience",
            str(SWEEP_PATIENCE),
            "--log_interval", "100", "--cache_dir", os.path.join(tmp, "c"),
            "--checkpoint_dir", os.path.join(tmp, "ck"), "--result_dir",
            os.path.join(tmp, "r"), "--device", "cuda"]


def phase_ensemble_uea(tmp: str, smi: str) -> dict:
    """(b) The UEA sweep: a SelfRegulationSCP2-shaped synthetic archive (7
    channels x 1152, 2 classes, 200 train and 180 test cases) through
    scripts/port_uea_ensemble_sweep.py with run_uea.sh's flags (InterpGN +
    FCN, f32), 6 epochs at patience 2, five seeds, and a missing dataset
    beside it; noise of deviation SCP2_NOISE added to the series
    (`add_noise`), so that early stopping is reached. Fails unless the native .ts scanner parsed the
    archive, each training step's warm-up and capture launch K1 30 and K2
    30 (six stride-1 banks a seed) and no K5/K6 and a replay nothing, the
    missing
    dataset is skipped, each seed's result equals a driver run with that
    seed alone, and a seed stopped early. Returns the launches counted
    over the sweep."""
    import importlib
    from sie_tpu_torch.data import native
    from sie_tpu_torch.data.synthetic import write_synthetic_uea
    from sie_tpu_torch.train import ensemble, ensemble_driver
    sys.path.insert(0, ROOT)
    sweep = importlib.import_module("scripts.port_uea_ensemble_sweep")
    root = os.path.join(tmp, "uea_scp2")
    write_synthetic_uea(root, "SelfRegulationSCP2", seed=0, **SCP2)
    for i, split in enumerate(("TRAIN", "TEST")):
        add_noise(os.path.join(root, "SelfRegulationSCP2",
                               f"SelfRegulationSCP2_{split}.ts"),
                  SCP2_NOISE, seed=i)
    counts = Counts()
    per_step, results = [], []
    step_fn = ensemble.EnsembleTrainer.train_step_staged
    run_fn = ensemble_driver.run_ensemble_experiment

    def counted_step(self, *a, **kw):
        c0 = counts.read()
        out = step_fn(self, *a, **kw)
        per_step.append(counts.since(c0))
        return out

    def recorded_run(*a, **kw):
        out = run_fn(*a, **kw)
        results.append(out)
        return out

    from sie_tpu_torch.run import args_to_config, get_args
    args = get_args([a for a in sweep_argv(root, tmp, [])
                     if a != "--datasets"])
    config = lambda s: args_to_config(args, seed=s).replace(
        data="UEA", dataset="SelfRegulationSCP2")
    # untimed: the process's first FCN steps, cuDNN's and the graphs' set-up
    run_fn(config(ENS_SEEDS[0]).replace(train_epochs=1),
           seeds=ENS_SEEDS[:1], verbose=False, device="cuda")
    parsed = native.files_parsed
    ensemble.EnsembleTrainer.train_step_staged = counted_step
    ensemble_driver.run_ensemble_experiment = recorded_run
    try:
        counts.zero()   # the path's main run
        t0 = time.perf_counter()
        summary = sweep.main(sweep_argv(root, tmp, ["SelfRegulationSCP2",
                                                    "Missing"]))
        sweep_s = time.perf_counter() - t0
        launches = counts.read()
        swept = native.files_parsed - parsed
    finally:
        ensemble.EnsembleTrainer.train_step_staged = step_fn
        ensemble_driver.run_ensemble_experiment = run_fn
    if not native.native_available() or swept < 2:
        fail(f"ensemble_uea: the native scanner parsed {swept} files")
    if set(summary) != {"SelfRegulationSCP2"} or len(results) != 1:
        fail(f"ensemble_uea: summary {summary}")
    want, none = Counts.full(UEA_ENS_WANT), Counts.full({})
    bad = [(k, got) for k, got in enumerate(per_step)
           if got != (want if k < 2 else none)]
    if bad or launches["K5"] or launches["K6"]:
        fail(f"ensemble_uea: step launches {bad[:3]}, run {launches}")
    lone_s, lone = [], []
    for s in ENS_SEEDS:
        t0 = time.perf_counter()
        lone += run_fn(config(s), seeds=(s,), verbose=False, device="cuda")
        lone_s.append(time.perf_counter() - t0)
    if lone != results[0]:
        fail(f"ensemble_uea: the sweep's seeds {results[0]} against lone "
             f"driver runs {lone}")
    if all(r["epoch_stop"] == SWEEP_EPOCHS - 1 for r in lone):
        fail(f"ensemble_uea: no seed stopped early: {lone}")
    print(f"[ensemble_uea] the sweep's native scanner parsed {swept} "
          f"files; {len(per_step)} training steps, launches of the first "
          f"two {per_step[:2]}, replays none; 'Missing' "
          f"skipped; results {results[0]} equal to five lone driver runs")
    print(f"[ensemble_uea] 5-seed sweep {sweep_s:.3f} s against five lone "
          f"driver runs {[round(v, 3) for v in lone_s]} = "
          f"{sum(lone_s):.3f} s; {smi}")
    return launches


def phase_ensembles(tmp: str, smi: str) -> tuple:
    """Phases 37-38 under one time limit -> the launches of (a) and (b)."""
    t0 = time.perf_counter()
    flagship = phase_ensemble(smi)
    t1 = time.perf_counter()
    uea = phase_ensemble_uea(tmp, smi)
    print(f"[ensemble] phases 37-38: {t1 - t0:.1f} + "
          f"{time.perf_counter() - t1:.1f} s")
    return flagship, uea


# ---- phase 39: training and serving over a device mesh ---------------------
MESH_FLAG = "--mesh-rank"   # argv[1] of a two-process rank: kinds, directory
CLI_PROBE_FLAG = "--cli-probe"   # argv[1] of a CLI process under time_probe
MESH_A_STEPS = 5       # (a): warm-up, capture, 3 replays, held bit for bit
MESH_A_TIMED = 10      # (a): replays timed, in turns with the lone trainer
MESH_ROWS, MESH_STEPS = 256, 3   # (b)/(c): rows held, eager global steps
MESH_SURE = 1e-4       # (b)/(c): |gradient| above which a parameter is held
# at rtol 1e-5 / atol 1e-6 (tests/test_torch_port_mesh_dist.py)
MESH_SIZES = (1, 5, 64)   # (e): request rows
SEQ_T = 844            # phase 40 (a): the flagship's T 845 does not split


def mesh_config():
    """(b)/(c): the flagship in f32 at dropout 0, global batch 64."""
    return train_config(amp=False)


def kind_config(kind: str):
    """The config a two-process run over axis `kind` trains: phase 39's
    for 'data' and 'model', the flagship at T SEQ_T for 'seq' and the MoE
    flagship (8 experts) for 'expert', each in f32 at dropout 0."""
    if kind == "seq":
        return mesh_config().replace(seq_len=SEQ_T)
    if kind == "expert":
        return mesh_config().replace(**MOE)
    return mesh_config()


def mesh_schedule(n_rows: int, b: int, steps: int) -> list:
    rng = np.random.default_rng(5)
    return [rng.permutation(n_rows)[:b] for _ in range(steps)]


def local_shapes(model) -> dict:
    """A rank's shapes of a bank, a query kernel and the FFN's first
    kernel (a MoE layer's expert stack)."""
    enc = model.deep_model.encoder.layers[0]
    ffn = (enc.moe_ffn.expert_wi if hasattr(enc, "moe_ffn") else
           enc.conv1.weight)
    return {"bank": list(model.sbm.shapelets_0.shape),
            "query": list(enc.attention.query.weight.shape),
            "ffn": list(ffn.shape)}


def time_probe() -> dict:
    """Records in this process the time width of every backbone forward
    (`registry.call_dnn`) and of every `comm.halo_seq` call:
    {"forward": [...], "halo": [...]}. Under a 'seq' axis a time-sharded
    backbone sees its rank's block and takes halos of it; a replicated
    one sees the whole T and takes none."""
    from sie_tpu_torch.models import registry
    from sie_tpu_torch.parallel import comm
    seen = {"forward": [], "halo": []}
    fwd, halo = registry.call_dnn, comm.halo_seq

    def call_dnn(dnn, x, padding_mask, generator):
        seen["forward"].append(int(x.shape[1]))
        return fwd(dnn, x, padding_mask, generator)

    def halo_seq(t, before, after, circular, dim=1):
        seen["halo"].append(int(t.shape[dim]))
        return halo(t, before, after, circular, dim)
    registry.call_dnn, comm.halo_seq = call_dnn, halo_seq
    return seen


def mesh_rank(kinds: str, out_dir: str) -> None:
    """One of the two processes of a run over each mesh axis in `kinds`
    (comma-separated), on the card that both share, over gloo: for each,
    MESH_STEPS eager `train_step`s of the global batch of `kind_config`;
    process 0 writes `<out_dir>/mesh_<kind>.npz`: the losses, the ms of
    each step, each step's launches, the (rows, T) of every K5 launch,
    the time widths of the steps' backbone forwards and halos
    (`time_probe`), this rank's local shapes and the gathered
    variables."""
    import torch.distributed as dist
    from sie_tpu_torch.compat.from_jax import _flatten, to_jax_variables
    from sie_tpu_torch.models import layers
    from sie_tpu_torch.parallel.mesh import Mesh
    from sie_tpu_torch.parallel.multihost import init_distributed
    from sie_tpu_torch.train.trainer import Trainer
    init_distributed(device="cuda:0")
    k5_shapes = []
    k5 = layers.fused_attention

    def recorded(q, *a, **kw):
        k5_shapes.append(list(q.shape[:2]))
        return k5(q, *a, **kw)
    layers.fused_attention = recorded
    seen = time_probe()
    for kind in kinds.split(","):
        if kind == "pipeline":
            pipeline_rank(out_dir, k5_shapes)
            continue
        cfg = kind_config(kind)
        ds = random_rows(cfg, MESH_ROWS)
        t = Trainer(cfg, MESH_STEPS, device="cuda:0",
                    mesh=Mesh((2,), (kind,)),
                    generator=torch.Generator().manual_seed(0))
        counts = Counts()
        w = np.ones(cfg.batch_size, np.float32)
        losses, ms, launches = [], [], []
        k5_shapes.clear()
        seen["forward"].clear()
        seen["halo"].clear()
        for idx in mesh_schedule(MESH_ROWS, cfg.batch_size, MESH_STEPS):
            counts.zero()
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = t.train_step((ds.x[idx], ds.y[idx],
                                    ds.padding_mask[idx], w), 1.0)
            losses.append(float(loss))
            ms.append(1e3 * (time.perf_counter() - t0))
            launches.append(counts.read())
        variables = to_jax_variables(t.model)    # gathered over the mesh
        if dist.get_rank() == 0:
            np.savez(os.path.join(out_dir, f"mesh_{kind}.npz"),
                     losses=np.asarray(losses), ms=np.asarray(ms),
                     meta=np.frombuffer(json.dumps(
                         {"launches": launches, "k5": k5_shapes,
                          "time": seen, "shapes": local_shapes(t.model)}
                     ).encode(),
                         np.uint8),
                     **{"/".join(k): v for k, v in _flatten(
                         variables["params"]).items()})
        del t, variables
        torch.cuda.empty_cache()
    dist.destroy_process_group()


def mesh_ranks(kinds: str, tmp: str) -> dict:
    """The two processes of `mesh_rank(kinds)` on this card -> {kind: what
    process 0 wrote}; a failing process fails the phase with both logs'
    tails."""
    env = {**os.environ, "SIE_TPU_COORDINATOR": f"localhost:{free_port()}",
           "SIE_TPU_NUM_PROCESSES": "2", "SIE_TPU_BACKEND": "gloo"}
    tag = kinds.replace(",", "_")
    logs = [os.path.join(tmp, f"mesh_{tag}_{i}.log") for i in range(2)]
    procs = []
    for i in range(2):
        with open(logs[i], "wb") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), MESH_FLAG, kinds,
                 tmp], env={**env, "SIE_TPU_PROCESS_ID": str(i)}, stdout=f,
                stderr=subprocess.STDOUT, cwd=ROOT))
        CHILDREN.append(procs[-1])
    deadline = time.time() + 240
    while any(p.poll() is None for p in procs) and time.time() < deadline:
        if any(p.poll() not in (None, 0) for p in procs):
            break    # one failed: the other waits at a collective
        time.sleep(0.5)
    codes = [p.poll() for p in procs]
    for p in procs:
        stop_server(p)
    if codes != [0, 0]:
        for i, log in enumerate(logs):
            with open(log, errors="replace") as f:
                print(f"[mesh] ({kinds}) process {i} exit {codes[i]}, log "
                      f"tail:\n{f.read()[-3000:]}")
        fail(f"mesh ({kinds}): the processes exited {codes}")
    out = {}
    for kind in kinds.split(","):
        got = dict(np.load(os.path.join(tmp, f"mesh_{kind}.npz")))
        got["meta"] = json.loads(bytes(got["meta"]).decode())
        out[kind] = got
    return out


def mesh_one_process(cfg=None):
    """The reference of a two-process run: one process on the global batch
    of `cfg` (default `mesh_config`) -> (losses, flax params by "/" path,
    each step's gradients by the same path)."""
    from sie_tpu_torch.compat.from_jax import (_flatten, to_jax_params,
                                               to_jax_tree)
    from sie_tpu_torch.train.trainer import Trainer
    cfg = cfg or mesh_config()
    ds = random_rows(cfg, MESH_ROWS)
    t = Trainer(cfg, MESH_STEPS, device="cuda",
                generator=torch.Generator().manual_seed(0))
    w = np.ones(cfg.batch_size, np.float32)
    flat = lambda tree: {"/".join(k): v for k, v in _flatten(tree).items()}
    losses, grads = [], []
    for idx in mesh_schedule(MESH_ROWS, cfg.batch_size, MESH_STEPS):
        loss, _ = t.train_step((ds.x[idx], ds.y[idx], ds.padding_mask[idx],
                                w), 1.0)
        losses.append(float(loss))
        grads.append(flat(to_jax_tree(t.model, {
            n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in t.model.named_parameters()})))
    out = losses, flat(to_jax_params(t.model)), grads
    del t
    torch.cuda.empty_cache()
    return out


def mesh_against_one(kind: str, got: dict, ref, lr: float) -> tuple:
    """A two-process run's losses and gathered parameters against one
    process: the CPU tests' limits -> (worst loss gap, worst held
    parameter gap)."""
    losses, params, grads = ref
    if not np.allclose(got["losses"], losses, rtol=1e-5, atol=1e-6):
        fail(f"mesh ({kind}): losses {got['losses'].tolist()} against one "
             f"process {losses}")
    worst = 0.0
    for key, want in params.items():
        sure = np.all([np.abs(g[key]) >= MESH_SURE for g in grads], axis=0)
        d = np.abs(got[key] - want)
        if not np.all(d[sure] <= 1e-6 + 1e-5 * np.abs(want[sure])) or \
                d.max() > MESH_STEPS * PARAM_TOL * lr:
            fail(f"mesh ({kind}): {key} differs from one process by "
                 f"{d[sure].max() if sure.any() else 0.0:.3e} where held, "
                 f"{d.max():.3e} in all")
        if sure.any():
            worst = max(worst, float(d[sure].max()))
    return float(np.abs(np.asarray(got["losses"]) - losses).max()), worst


def mesh_world_one(smi: str) -> dict:
    """(a): the flagship at dropout RATE on a one-process NCCL group and
    `Mesh((1,), ("data",))` against the same trainer without a mesh:
    staged steps (warm-up, capture, replays) bit for bit, the launches of
    the warm-up and the capture, the all-reduces the capture holds, and
    the replay ms of both -> the mesh trainer's launches."""
    import torch.distributed as dist
    from sie_tpu_torch.parallel import comm
    from sie_tpu_torch.parallel.mesh import Mesh
    from sie_tpu_torch.train.trainer import Trainer
    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0,
                            device_id=dev)
    try:
        mesh = Mesh((1,), ("data",))
        cfg = train_config(dropout=RATE)
        ds = random_rows(cfg, 256)
        b = cfg.batch_size
        rng = np.random.default_rng(2)
        steps = [(rng.permutation(len(ds.y))[:b], np.ones(b, np.float32))
                 for _ in range(MESH_A_STEPS)]
        trainers = [Trainer(cfg, MESH_A_STEPS, device="cuda", mesh=m,
                            generator=torch.Generator().manual_seed(0))
                    for m in (None, mesh)]
        devs = [t.device_data("train", ds) for t in trainers]
        staged = [t.stage_steps(steps, 1.0) for t in trainers]
        counts, reduces = Counts(), []
        real = comm.all_reduce_

        def counted(t, group):
            reduces.append(tuple(t.shape))
            return real(t, group)

        mesh_launches = Counts.full({})
        for k in range(MESH_A_STEPS):
            losses = []
            for i, t in enumerate(trainers):
                counts.zero()
                comm.all_reduce_ = counted
                try:
                    loss, _ = t.train_step_staged(devs[i], staged[i], k)
                finally:
                    comm.all_reduce_ = real
                losses.append(float(loss))
                got = counts.read()
                want = Counts.full(TRAIN_WANT if k < 2 else {})
                if got != want:
                    fail(f"mesh (a): step {k} of the {'mesh' if i else 'lone'}"
                         f" trainer launched {got}, want {want}")
                if i:
                    mesh_launches = {n: mesh_launches[n] + got[n]
                                     for n in got}
            same = all(torch.equal(p, q) for p, q in zip(
                trainers[0].model.parameters(), trainers[1].model.parameters()))
            if losses[0] != losses[1] or not same:
                fail(f"mesh (a): step {k}: losses {losses}, parameters "
                     f"bit-equal {same}")
        if len(reduces) != 8 or len(trainers[1].captures) != 1:
            fail(f"mesh (a): all-reduces issued {reduces}, captures "
                 f"{trainers[1].captures}")
        times = {0: [], 1: []}
        for r in range(MESH_A_TIMED):
            for i, t in enumerate(trainers):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                t.train_step_staged(devs[i], staged[i], r % MESH_A_STEPS)
                torch.cuda.synchronize()
                times[i].append(1e3 * (time.perf_counter() - t0))
        med = {i: float(np.median(v)) for i, v in times.items()}
        print(f"[mesh] (a) world-1 NCCL mesh, flagship B={b}, dropout "
              f"{RATE}: {MESH_A_STEPS} staged steps (warm-up, capture, "
              f"replays) bit-equal to the trainer without a mesh, losses "
              f"and parameters; launches at warm-up and capture "
              f"{Counts.full(TRAIN_WANT)} each, none at a replay; the "
              f"capture holds {len(reduces) // 2} all-reduces (weight sums "
              f"of the two heads, the gradients "
              f"({max(int(np.prod(r)) for r in reduces)} f32), the loss)")
        print(f"[mesh] (a) replay ms, {MESH_A_TIMED} each in turns: mesh "
              + ", ".join(f"{v:.3f}" for v in times[1]) + f"; median "
              f"{med[1]:.3f} against the lone replay's {med[0]:.3f} "
              f"(+{med[1] - med[0]:.3f} ms); {smi}")
        return mesh_launches
    finally:
        dist.destroy_process_group()


def cli_probe(argv) -> None:
    """`sie_tpu_torch.run.main(argv)` under `time_probe`, then one line
    `[probe] {"forward": {width: count}, "halo": {width: count}}`."""
    import collections
    from sie_tpu_torch.run import main as run_main
    seen = time_probe()
    run_main(argv)
    print("[probe] " + json.dumps({k: collections.Counter(v)
                                   for k, v in seen.items()}), flush=True)


def cli_two_processes(argv, tmp: str, tag: str, timeout: float,
                      probe: bool = False) -> tuple:
    """`python -m sie_tpu_torch.run *argv` as two processes (the launch
    variables, gloo, both on this card) -> (exit codes, both outputs).
    With `probe` each process runs it through `cli_probe`."""
    env = {**os.environ, "SIE_TPU_COORDINATOR": f"localhost:{free_port()}",
           "SIE_TPU_NUM_PROCESSES": "2", "SIE_TPU_BACKEND": "gloo"}
    logs = [os.path.join(tmp, f"{tag}_{i}.log") for i in range(2)]
    procs = []
    for i in range(2):
        with open(logs[i], "wb") as f:
            procs.append(subprocess.Popen(
                [sys.executable, *([os.path.abspath(__file__), CLI_PROBE_FLAG]
                                   if probe else ["-m", "sie_tpu_torch.run"]),
                 *argv],
                env={**env, "SIE_TPU_PROCESS_ID": str(i)}, stdout=f,
                stderr=subprocess.STDOUT, cwd=ROOT))
        CHILDREN.append(procs[-1])
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            codes.append(None)
        stop_server(p)
    texts = []
    for log in logs:
        with open(log, errors="replace") as f:
            texts.append(f.read())
    return codes, texts


def mesh_loso(tmp: str) -> None:
    """(d): phase 26's --loso command as two processes (the launch
    variables, gloo, both on this card) through `python -m
    sie_tpu_torch.run`: the folds split disjoint and whole, each fold's
    accuracy that of the one-process run (phase 26, or run here when
    phase 26 did not run)."""
    argv = LOSO_CLI.split() + [
        "--data_root", os.path.join(tmp, "no_chisco_loso"),
        "--checkpoint_dir", os.path.join(tmp, "ck_loso_mh"),
        "--result_dir", os.path.join(tmp, "result"),
        "--cache_dir", os.path.join(tmp, "cache")]
    if not LOSO_ACCURACY:
        text, _ = run_cli(argv[:argv.index("--checkpoint_dir") + 1]
                          + [os.path.join(tmp, "ck_loso")]
                          + argv[argv.index("--checkpoint_dir") + 2:])
        LOSO_ACCURACY.update({int(k): float(v) for k, v in re.findall(
            r"\[LOSO\] subject (\d+): acc ([0-9.]+)%", text)})
    t0 = time.perf_counter()
    codes, texts = cli_two_processes(argv, tmp, "loso_mh", 240)
    secs = time.perf_counter() - t0
    folds, accs, took = [], {}, []
    for i, text in enumerate(texts):
        m = re.search(r"\[multihost\] process (\d)/2 took folds "
                      r"slice\((\d+), (\d+), None\)", text)
        got = [int(s) for s in re.findall(r"\[LOSO\] subject (\d+)", text)]
        if codes[i] != 0 or not m or int(m.group(1)) != i or \
                got != list(range(int(m.group(2)), int(m.group(3)))):
            print(f"[mesh] (d) process {i} exit {codes[i]}, log tail:\n"
                  f"{text[-3000:]}")
            fail(f"mesh (d): process {i} exited {codes[i]} with folds {got}")
        took.append(m.group(0))
        folds.extend(got)
        accs.update({int(k): float(v) for k, v in re.findall(
            r"\[LOSO\] subject (\d+): acc ([0-9.]+)%", text)})
    if sorted(folds) != [0, 1, 2] or accs != LOSO_ACCURACY:
        fail(f"mesh (d): folds {folds}, accuracies {accs} against one "
             f"process {LOSO_ACCURACY}")
    print(f"[mesh] (d) --loso over 2 processes on this card: {took}; fold "
          f"accuracies {accs} equal to the one-process run; {secs:.1f} s")


def mesh_serving() -> dict:
    """(e): `Predictor` over `Mesh((1,), ("data",), devices=["cuda:0"])`
    (its row block on a stream of its own) against the predictor without
    a mesh at MESH_SIZES rows: every output bit-equal, K1 6 and K5 2 a
    request -> the launches."""
    from sie_tpu_torch.compat.from_jax import to_jax_variables
    from sie_tpu_torch.models.registry import build_model
    from sie_tpu_torch.parallel.mesh import Mesh
    from sie_tpu_torch.serve import Predictor
    cfg = flagship_config()
    variables = to_jax_variables(build_model(
        cfg, "cpu", torch.Generator().manual_seed(0)))
    plain = Predictor(cfg, variables, device="cuda", max_batch=64)
    meshed = Predictor(cfg, variables, max_batch=64,
                       mesh=Mesh((1,), ("data",), devices=["cuda:0"]))
    rng = np.random.default_rng(4)
    counts = Counts()
    launches = Counts.full({})
    for b in MESH_SIZES:
        x = rng.normal(size=(b, cfg.seq_len, cfg.enc_in)).astype(np.float32)
        want = plain.predict(x)
        counts.zero()
        got = meshed.predict(x)
        c = counts.read()
        if c != Counts.full({"K1": 6, "K5": 2}):
            fail(f"mesh (e): a {b}-row request launched {c}")
        launches = {n: launches[n] + c[n] for n in c}
        for f in OUT_FIELDS:
            if not np.array_equal(getattr(got, f), getattr(want, f)):
                fail(f"mesh (e): {f} of a {b}-row request differs")
    print(f"[mesh] (e) Predictor over a one-device mesh: every output "
          f"bit-equal to the predictor without a mesh at {MESH_SIZES} rows; "
          f"launches {launches}")
    return launches


def phase_mesh(tmp: str, smi: str) -> dict:
    """Phase 39, (a)-(e), each a check of its own -> the launches of (a),
    (b), (c) and (e) summed (the mesh path's)."""
    t0 = time.perf_counter()
    total = mesh_world_one(smi)
    lap_a = time.perf_counter()
    cfg = mesh_config()
    ref = mesh_one_process()
    t1 = time.perf_counter()
    runs = mesh_ranks("data,model", tmp)
    for kind, got in runs.items():
        loss_gap, param_gap = mesh_against_one(kind, got, ref, cfg.lr)
        meta = got["meta"]
        for step in meta["launches"]:
            if step != Counts.full(TRAIN_WANT):
                fail(f"mesh ({kind}): a step launched {step} on rank 0")
            total = {n: total[n] + step[n] for n in total}
        want_shapes = ({"bank": [10, 122, 43], "query": [512, 512],
                        "ffn": [2048, 512]} if kind == "data" else
                       {"bank": [5, 122, 43], "query": [256, 512],
                        "ffn": [1024, 512]})
        if meta["shapes"] != want_shapes:
            fail(f"mesh ({kind}): local shapes {meta['shapes']}")
        print(f"[mesh] ({'b' if kind == 'data' else 'c'}) '{kind}' over 2 "
              f"processes on this card (gloo), flagship f32 B=64 "
              f"({'32 rows a rank' if kind == 'data' else 'banks of 5 shapelets, 4 heads and 1024 FFN columns a rank'}): "
              f"{MESH_STEPS} losses {got['losses'].tolist()} within "
              f"{loss_gap:.3e} of one process, gathered parameters within "
              f"{param_gap:.3e} where held; ms a global step "
              + ", ".join(f"{v:.1f}" for v in got["ms"])
              + f"; launches a step {TRAIN_WANT} on rank 0; {smi}")
    t2 = time.perf_counter()
    mesh_loso(tmp)
    t3 = time.perf_counter()
    served = mesh_serving()
    total = {n: total[n] + served[n] for n in total}
    print(f"[mesh] phase 39: (a) {lap_a - t0:.1f} s, one-process reference "
          f"{t1 - lap_a:.1f} s, (b) + (c) in one pair of processes "
          f"{t2 - t1:.1f} s, (d) {t3 - t2:.1f} s, (e) "
          f"{time.perf_counter() - t3:.1f} s; launches {total}")
    return total


# ---- phase 40: the 'seq' and 'expert' mesh axes ---------------------------
SX_UEA = dict(n_train=64, n_test=32, n_dims=8, length=200, n_classes=3)
# (c), two processes against one: each epoch's train loss, validation
# loss and the test loss, the limits of tests/test_torch_port_mesh_cli.py
# (FCN's conv biases before a BatchNorm move with rounding noise, which
# the eval losses read through the running means)
SX_TRAIN_ATOL, SX_EVAL_ATOL = 1e-4, 2e-3
SX_SHAPES = {   # (a)/(b): a rank's parameter shapes (none split by 'seq')
    "seq": {"bank": [10, 122, 43], "query": [512, 512], "ffn": [2048, 512]},
    "expert": {"bank": [10, 122, 43], "query": [512, 512],
               "ffn": [4, 512, 2048]}}


def sx_cli(tmp: str) -> None:
    """(c): `python -m sie_tpu_torch.run --mesh 2 --mesh_axes seq` over
    synthetic UEA (T 200) with the FCN expert in f32, two processes on
    this card, against one process: the test accuracy equal, each
    epoch's train loss within SX_TRAIN_ATOL, its validation loss and the
    test loss within SX_EVAL_ATOL; process 0's FCN forwards each on a
    block of T/2 steps with its three halos (`cli_probe`)."""
    import glob
    import pickle
    from sie_tpu_torch.data.synthetic import write_synthetic_uea
    root = os.path.join(tmp, "sx_uea")
    write_synthetic_uea(root, "SxToy", seed=11, **SX_UEA)
    argv = ["--data", "UEA", "--data_root", root, "--dataset", "SxToy",
            "--model", "InterpGN", "--dnn_type", "FCN", "--no-amp",
            "--num_shapelet", "10", "--batch_size", "16", "--train_epochs",
            "2", "--patience", "5", "--log_interval", "1", "--seed", "0",
            "--result_dir", os.path.join(tmp, "sx_result"), "--cache_dir",
            os.path.join(tmp, "cache")]
    t0 = time.perf_counter()
    one_text, res = run_cli(argv + ["--device", "cuda", "--checkpoint_dir",
                                     os.path.join(tmp, "sx_ck_one")])
    one_loss, one_acc = res[0][1], res[0][2]["accuracy"]
    t1 = time.perf_counter()
    codes, texts = cli_two_processes(argv + [
        "--device", "cuda:0", "--mesh", "2", "--mesh_axes", "seq",
        "--checkpoint_dir", os.path.join(tmp, "sx_ck_seq")], tmp, "sx_cli",
        180, probe=True)
    if codes != [0, 0]:
        for i, text in enumerate(texts):
            print(f"[seq_expert] (c) process {i} exit {codes[i]}, log "
                  f"tail:\n{text[-3000:]}")
        fail(f"seq_expert (c): the processes exited {codes}")
    text = texts[0]
    accs = re.findall(r"Test accuracy ([0-9.]+)%", text)
    pkl = glob.glob(os.path.join(tmp, "sx_ck_seq", "**",
                                 "test_results.pkl"), recursive=True)
    if len(accs) != 1 or len(pkl) != 1:
        fail(f"seq_expert (c): accuracies printed {accs}, results {pkl}")
    with open(pkl[0], "rb") as f:
        saved = pickle.load(f)
    loss, acc = saved["test_loss"], saved["test_metrics"]["accuracy"]
    epochs = [np.array(re.findall(r"Train Loss ([0-9.]+) \| Val Loss "
                                  r"([0-9.]+)", t), float).reshape(-1, 2)
              for t in (text, one_text)]
    same = epochs[0].shape == epochs[1].shape and len(epochs[0]) > 0
    gaps = np.abs(epochs[0] - epochs[1]).max(0) if same else None
    if round(acc, 2) != round(one_acc, 2) or not same or \
            abs(loss - one_loss) > SX_EVAL_ATOL or \
            gaps[0] > SX_TRAIN_ATOL or gaps[1] > SX_EVAL_ATOL:
        fail(f"seq_expert (c): two processes test at {acc:.2f}% loss "
             f"{loss!r}, epochs (train, val) {epochs[0].tolist()}; one "
             f"process at {one_acc:.2f}% loss {one_loss!r}, epochs "
             f"{epochs[1].tolist()}")
    # every FCN forward on a rank's block, its three VALID convs' halos
    block = str(SX_UEA["length"] // 2)
    probe = re.findall(r"^\[probe\] (.*)$", text, re.M)
    seen = json.loads(probe[0]) if len(probe) == 1 else {}
    forwards = seen.get("forward", {}).get(block, 0)
    if not forwards or seen != {"forward": {block: forwards},
                                "halo": {block: 3 * forwards}}:
        fail(f"seq_expert (c): process 0's backbone forwards and halos saw "
             f"time widths {seen or probe}, want only blocks of {block}")
    print(f"[seq_expert] (c) --mesh 2 --mesh_axes seq, InterpGN + FCN f32 "
          f"on synthetic UEA (T {SX_UEA['length']}), two processes on this "
          f"card: on process 0 {forwards} FCN forwards, each on a block of "
          f"{block} steps, and {3 * forwards} halo exchanges; test accuracy "
          f"{acc:.2f}% and loss "
          f"{loss:.6f} against one process's {one_acc:.2f}% and "
          f"{one_loss:.6f} (gap {abs(loss - one_loss):.3e}), epochs' train "
          f"and validation losses within {gaps[0]:.1e} and {gaps[1]:.1e} "
          f"(as printed, 4 decimals); one process "
          f"{t1 - t0:.1f} s, two {time.perf_counter() - t1:.1f} s")


def sx_task(tmp: str) -> None:
    """(d): `--mesh 2` with a forecast task trains in this one process on
    the card and says that the mesh is ignored, as the JAX CLI does."""
    from sie_tpu_torch.data.synthetic import write_synthetic_ett
    root = os.path.join(tmp, "sx_task")
    write_synthetic_ett(os.path.join(root, "ett.csv"), n_rows=2000)
    t0 = time.perf_counter()
    text, res = run_cli([
        "--task_name", "long_term_forecast", "--mesh", "2", "--device",
        "cuda:0", "--data", "custom", "--dataset", "ett", "--data_root",
        root, "--model", "DNN", "--train_epochs", "1", "--batch_size", "32",
        "--d_model", "64", "--d_ff", "128", "--n_heads", "4", "--e_layers",
        "1", "--d_layers", "1", "--seed", "0", "--result_dir",
        os.path.join(tmp, "sx_task_result"), "--checkpoint_dir",
        os.path.join(tmp, "sx_task_ck"), "--cache_dir",
        os.path.join(tmp, "cache")])
    metrics = res[0][2] if res else {}
    if "[long_term_forecast] --mesh 2 is ignored" not in text or \
            not metrics or not all(np.isfinite(v) for v in metrics.values()):
        fail(f"seq_expert (d): the task with --mesh 2 gave {metrics}")
    print(f"[seq_expert] (d) --mesh 2 with long_term_forecast: trained in "
          f"this process on the card, mesh ignored; "
          + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
          + f"; {time.perf_counter() - t0:.1f} s")


def sx_serving() -> dict:
    """(e): `Predictor` over a single-process ('data', 'seq') mesh (the
    flagship) and a ('data', 'expert') mesh (the MoE flagship) of two
    'cuda:0' entries, against the predictor without a mesh at MESH_SIZES
    rows: every output bit-equal, K1 6 and K5 2 a request -> the
    launches by axis."""
    from sie_tpu_torch.compat.from_jax import to_jax_variables
    from sie_tpu_torch.models.registry import build_model
    from sie_tpu_torch.parallel.mesh import Mesh
    from sie_tpu_torch.serve import Predictor
    out = {}
    rng = np.random.default_rng(6)
    counts = Counts()
    for kind, cfg in (("seq", flagship_config()),
                      ("expert", flagship_config().replace(**MOE))):
        variables = to_jax_variables(build_model(
            cfg, "cpu", torch.Generator().manual_seed(0)))
        plain = Predictor(cfg, variables, device="cuda", max_batch=64)
        meshed = Predictor(cfg, variables, max_batch=64, mesh=Mesh(
            (1, 2), ("data", kind), devices=["cuda:0", "cuda:0"]))
        launches = Counts.full({})
        for b in MESH_SIZES:
            x = rng.normal(size=(b, cfg.seq_len, cfg.enc_in)).astype(
                np.float32)
            want = plain.predict(x)
            counts.zero()
            got = meshed.predict(x)
            c = counts.read()
            if c != Counts.full({"K1": 6, "K5": 2}):
                fail(f"seq_expert (e): a {b}-row request over '{kind}' "
                     f"launched {c}")
            launches = {n: launches[n] + c[n] for n in c}
            for f in OUT_FIELDS:
                if not np.array_equal(getattr(got, f), getattr(want, f)):
                    fail(f"seq_expert (e): {f} of a {b}-row request over "
                         f"'{kind}' differs")
        out[kind] = launches
        del plain, meshed
    print(f"[seq_expert] (e) Predictor over ('data', 'seq') and ('data', "
          f"'expert') meshes: every output bit-equal to the predictor "
          f"without a mesh at {MESH_SIZES} rows; launches {out}")
    return out


def phase_seq_expert(tmp: str, smi: str) -> tuple:
    """Phase 40, (a)-(e), each a check of its own -> the launches of the
    'seq' path ((a)'s steps on rank 0 and (e)'s requests) and of the
    'expert' path ((b) and (e))."""
    t0 = time.perf_counter()
    refs = {kind: mesh_one_process(kind_config(kind))
            for kind in ("seq", "expert")}
    t1 = time.perf_counter()
    runs = mesh_ranks("seq,expert", tmp)
    total = {}
    for part, (kind, got) in zip("ab", runs.items()):
        cfg = kind_config(kind)
        loss_gap, param_gap = mesh_against_one(kind, got, refs[kind], cfg.lr)
        meta = got["meta"]
        launched = Counts.full({})
        for step in meta["launches"]:
            if step != Counts.full(TRAIN_WANT):
                fail(f"seq_expert ({part}): a step launched {step} on "
                     f"rank 0")
            launched = {n: launched[n] + step[n] for n in launched}
        rows = cfg.batch_size * cfg.n_heads
        if meta["shapes"] != SX_SHAPES[kind] or any(
                k5 != [rows, cfg.seq_len] for k5 in meta["k5"]):
            fail(f"seq_expert ({part}): local shapes {meta['shapes']}, K5 "
                 f"launched at (rows, T) {meta['k5']}")
        # 'seq': the backbone on the rank's block, one halo (the token
        # embedding's) a forward; 'expert': the whole T, no halo
        block = cfg.seq_len // 2 if kind == "seq" else cfg.seq_len
        want = {"forward": [block] * MESH_STEPS,
                "halo": [block] * MESH_STEPS if kind == "seq" else []}
        if meta["time"] != want:
            fail(f"seq_expert ({part}): the backbone's forwards and halos "
                 f"saw time widths {meta['time']}, want {want}")
        total[kind] = launched
        what = (f"the Transformer's forwards on time blocks of "
                f"{meta['time']['forward'][0]} steps with "
                f"{len(meta['time']['halo'])} halo exchanges, K5 at the "
                f"whole T" if kind == "seq" else
                f"{meta['shapes']['ffn'][0]} of the {cfg.moe_experts} "
                f"experts a rank")
        print(f"[seq_expert] ({part}) '{kind}' over 2 processes on this "
              f"card (gloo), {'flagship' if kind == 'seq' else 'MoE flagship'}"
              f" f32 B={cfg.batch_size} T={cfg.seq_len} ({what}): "
              f"{MESH_STEPS} losses {got['losses'].tolist()} within "
              f"{loss_gap:.3e} of one process, gathered parameters within "
              f"{param_gap:.3e} where held; ms a global step "
              + ", ".join(f"{v:.1f}" for v in got["ms"])
              + f"; launches a step {TRAIN_WANT} on rank 0, K5 at (rows, T) "
              f"{meta['k5'][0]}; {smi}")
    t2 = time.perf_counter()
    sx_cli(tmp)
    t3 = time.perf_counter()
    sx_task(tmp)
    t4 = time.perf_counter()
    served = sx_serving()
    for kind in total:
        total[kind] = {n: total[kind][n] + served[kind][n]
                       for n in total[kind]}
    print(f"[seq_expert] phase 40: one-process references {t1 - t0:.1f} s, "
          f"(a) + (b) in one pair of processes {t2 - t1:.1f} s, (c) "
          f"{t3 - t2:.1f} s, (d) {t4 - t3:.1f} s, (e) "
          f"{time.perf_counter() - t4:.1f} s; launches {total}")
    return total["seq"], total["expert"]


# ---- phase 41: the 'pipe' axis and the GPipe executor -----------------------
PIPE_B, PIPE_M = 64, 4     # (a)/(c): batch and microbatches of the pipeline
PIPE_TOL = {False: 1e-4, True: 5e-2}   # (a) by amp: the forward (x max
# |want|) and each leaf's gradient (x its max |g|; a leaf whose max |g| is
# below 1e-6 of the tree's, x the tree's) against the sequential encoder
PIPE_TIMED = 5             # (a): forward + backward passes timed
PIPE_SHAPES = {"bank": [10, 122, 43], "query": [512, 512],
               "ffn": [2048, 512]}   # (b): nothing split over 'pipe'
SNAP_STEPS = 2             # (d): steps before and after the snapshot


def pipe_encoder_config(amp: bool):
    """(a): the flagship's encoder settings (d_model 512, 8 heads, d_ff
    2048, 2 layers: one a stage), at dropout 0."""
    return flagship_config().replace(amp=amp, batch_size=PIPE_B)


def leaf_errors(got: dict, want: dict) -> float:
    """The worst per-leaf max |got - want| / the leaf's max |want| (a leaf
    whose max is below 1e-6 of the tree's, rounding noise: over the
    tree's)."""
    top = max(float(np.abs(w).max()) for w in want.values())
    worst = 0.0
    for key, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-6 * top)
        worst = max(worst, float(np.abs(got[key] - w).max()) / scale)
    return worst


def pipeline_rank(out_dir: str, k5_shapes: list) -> None:
    """Phase 41 (a) and (c) in one of the two processes of `mesh_rank`,
    over `Mesh((2,), ("pipe",))`: for f32 and bf16 amp, this rank's stage
    of the flagship encoder pipelined (M 4) against the sequential encoder
    run here at the same weights (forward, and the gradients of
    sum(sin(out)): this stage's leaves, `norm`, the input's), its K5/K6
    launches and K5 shapes, and the ms of PIPE_TIMED forward + backward
    passes of both (the sequential one timed on rank 0 while rank 1
    waits); then the MoE flagship encoder in training with its aux against
    the sequential layers a microbatch at a time, and the ValueError
    without the aux. Process 0 writes `<out_dir>/mesh_pipeline.npz` with
    both ranks' numbers."""
    import torch.distributed as dist
    from sie_tpu_torch.compat.from_jax import (_flatten, load_jax_stage,
                                               to_jax_params, to_jax_tree)
    from sie_tpu_torch.parallel.mesh import Mesh
    from sie_tpu_torch.parallel.pipeline import (encoder_stage,
                                                 pipelined_encoder_apply)
    mesh = Mesh((2,), ("pipe",))
    s = mesh.index("pipe")
    dev = torch.device("cuda", 0)
    counts = Counts()
    flat = lambda tree: {"/".join(k): v for k, v in _flatten(tree).items()}
    out = {"rank": s}

    def grads_of(module, rename=None):
        tree = to_jax_tree(module, {n: p.grad for n, p in
                                    module.named_parameters()})
        return flat({rename(k) if rename else k: v for k, v in tree.items()})

    x_host = np.random.default_rng(1).normal(
        size=(PIPE_B, 845, 512)).astype(np.float32)
    for amp in (False, True):
        tag = "bf16" if amp else "f32"
        cfg = pipe_encoder_config(amp)
        full = encoder_stage(cfg, 1, torch.Generator().manual_seed(0),
                             dev).eval()
        stage = load_jax_stage(encoder_stage(cfg, 2, device=dev),
                               to_jax_params(full), s, 2)
        x = torch.from_numpy(x_host).to(dev)
        xs = x.clone().requires_grad_(True)
        want = full(xs)
        torch.sin(want).sum().backward()
        xp = x.clone().requires_grad_(True)
        torch.cuda.synchronize()
        counts.zero()
        k5_shapes.clear()
        got = pipelined_encoder_apply(cfg, stage, xp, mesh,
                                      n_microbatches=PIPE_M)
        torch.cuda.synchronize()
        fwd = counts.read()
        counts.zero()
        torch.sin(got).sum().backward()
        torch.cuda.synchronize()
        bwd = counts.read()
        per = len(stage.layers)
        rename = lambda k: k if k == "norm" else \
            f"layer_{s * per + int(k[6:])}"
        mine = grads_of(stage, rename)
        ref = {k: v for k, v in grads_of(full).items() if k in mine}
        xgrad = xp.grad.cpu().numpy()
        out[tag] = {
            "fwd": fwd, "bwd": bwd, "k5": [list(t) for t in k5_shapes],
            "forward_err": float((got - want).abs().max()
                                 / want.abs().max()),
            "grad_err": leaf_errors(mine, ref),
            "x_err": (leaf_errors({"x": xgrad},
                                  {"x": xs.grad.cpu().numpy()}) if s == 0
                      else float(np.abs(xgrad).max())),
            "leaves": len(mine)}
        ms = []
        for _ in range(PIPE_TIMED):
            stage.zero_grad(set_to_none=True)
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = pipelined_encoder_apply(cfg, stage, xp, mesh,
                                        n_microbatches=PIPE_M)
            torch.sin(o).sum().backward()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        seq_ms = []
        dist.barrier()
        if s == 0:
            for _ in range(PIPE_TIMED):
                full.zero_grad(set_to_none=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                torch.sin(full(xs)).sum().backward()
                torch.cuda.synchronize()
                seq_ms.append(1e3 * (time.perf_counter() - t0))
        dist.barrier()
        out[tag].update(ms=ms, seq_ms=seq_ms)
        del full, stage, want, got, o, x, xs, xp
        torch.cuda.empty_cache()
    # (c) the MoE flagship encoder, in training, with its aux
    cfg = kind_config("expert")
    full = encoder_stage(cfg, 1, torch.Generator().manual_seed(0), dev)
    stage = load_jax_stage(encoder_stage(cfg, 2, device=dev),
                           to_jax_params(full), s, 2)
    x = torch.from_numpy(x_host).to(dev)
    full.train()
    ys, auxes = [], []
    with torch.no_grad():
        for mb in x.chunk(PIPE_M):
            sown = []
            ys.append(full(mb, None, sown))
            auxes.append(float(sum(a.float().sum() for a in sown)))
    want = torch.cat(ys)
    try:
        pipelined_encoder_apply(cfg, stage, x, mesh, n_microbatches=PIPE_M,
                                train=True)
        raised = ""
    except ValueError as e:
        raised = str(e)
    counts.zero()
    got, aux = pipelined_encoder_apply(cfg, stage, x, mesh,
                                       n_microbatches=PIPE_M, train=True,
                                       return_aux=True,
                                       generator=torch.Generator(dev))
    (torch.sin(got).sum() + aux).backward()
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(p.grad).all())
                 for p in stage.parameters() if p.grad is not None)
    out["moe"] = {"launches": counts.read(), "aux": float(aux),
                  "want_aux": float(np.mean(auxes)),
                  "forward_err": float((got - want).abs().max()
                                       / want.abs().max()),
                  "raised": raised, "finite": finite}
    del full, stage, got, want, x
    torch.cuda.empty_cache()
    both = [None, None]
    dist.all_gather_object(both, out)
    if s == 0:
        np.savez(os.path.join(out_dir, "mesh_pipeline.npz"),
                 meta=np.frombuffer(json.dumps(both).encode(), np.uint8))


def pipe_snapshot(smi: str) -> dict:
    """(d): the flagship Trainer at dropout RATE takes SNAP_STEPS steps and
    writes `train_state.msgpack` in the JAX package's layout; a new
    trainer loads it and takes SNAP_STEPS more, bit for bit the last steps
    of a trainer that took all of them -> the launches of every step."""
    from sie_tpu_torch.compat import flax_msgpack
    from sie_tpu_torch.train import checkpoint as ckpt
    from sie_tpu_torch.train.trainer import Trainer
    import tempfile
    cfg = train_config(dropout=RATE)
    ds = random_rows(cfg, MESH_ROWS)
    w = np.ones(cfg.batch_size, np.float32)
    batches = [(ds.x[i], ds.y[i], ds.padding_mask[i], w) for i in
               mesh_schedule(MESH_ROWS, cfg.batch_size, 2 * SNAP_STEPS)]
    mk = lambda seed: Trainer(cfg, 2 * SNAP_STEPS, device="cuda",
                              generator=torch.Generator().manual_seed(seed))
    counts = Counts()
    counts.zero()
    whole = mk(0)
    want = [whole.train_step(b, 1.0)[0] for b in batches]
    first = mk(0)
    for b in batches[:SNAP_STEPS]:
        first.train_step(b, 1.0)
    d = tempfile.mkdtemp(prefix="chip_smoke_snap_")
    try:
        t0 = time.perf_counter()
        ckpt.save_train_state(d, first, 1, {"best_score": 0.0, "counter": 0,
                                            "has_best": False})
        save_s = time.perf_counter() - t0
        path = os.path.join(d, ckpt.FULL_STATE_NAME)
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            keys = sorted(flax_msgpack.from_bytes(f.read()))
        del first
        again = mk(1)                     # other weights: all from the file
        ckpt.load_train_state(d, again)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    got = [again.train_step(b, 1.0)[0] for b in batches[SNAP_STEPS:]]
    launched = counts.read()
    if keys != ["batch_stats", "early", "epoch", "opt_state", "params",
                "rng", "step"]:
        fail(f"pipe (d): the snapshot holds {keys}")
    gaps = [float((g - w_).abs().max()) for g, w_ in
            zip(got, want[SNAP_STEPS:])]
    with torch.no_grad():
        pgap = max(float((p - q).abs().max()) for p, q in zip(
            whole.model.parameters(), again.model.parameters()))
    if any(gaps) or pgap:
        fail(f"pipe (d): the resumed steps' losses differ by {gaps} and "
             f"the parameters by {pgap:.3e} from the uninterrupted run "
             f"(the same kernels on the same card, so any gap is a state "
             f"the snapshot lost)")
    steps = 4 * SNAP_STEPS      # the whole run's, the first's, the resumed
    if launched != Counts.full(TRAIN_WANT, steps):
        fail(f"pipe (d): {steps} steps launched {launched}")
    print(f"[pipe] (d) the flagship Trainer at dropout {RATE}: "
          f"{SNAP_STEPS} steps, train_state.msgpack in the JAX package's "
          f"layout ({size / 2 ** 20:.1f} MiB, keys {keys}, written in "
          f"{save_s:.2f} s), a new trainer loads it and takes {SNAP_STEPS} "
          f"more: losses {[float(g) for g in got]} and parameters bit-equal "
          f"to the uninterrupted run; {smi}")
    del whole, again
    torch.cuda.empty_cache()
    return launched


def phase_pipe(tmp: str, smi: str) -> dict:
    """Phase 41, (a)-(d), each a check of its own -> the launches of the
    'pipe' path: (b)'s steps on rank 0, (a)'s and (c)'s pipelines on rank
    0, (d)'s steps."""
    t0 = time.perf_counter()
    ref = mesh_one_process()
    t1 = time.perf_counter()
    runs = mesh_ranks("pipe,pipeline", tmp)
    t2 = time.perf_counter()
    # (b) 'pipe' is replication in the Trainer, as in the JAX package
    got = runs["pipe"]
    meta = got["meta"]
    total = Counts.full({})
    for step in meta["launches"]:
        if step != Counts.full(TRAIN_WANT):
            fail(f"pipe (b): a step launched {step} on rank 0")
        total = {n: total[n] + step[n] for n in total}
    if meta["shapes"] != PIPE_SHAPES:
        fail(f"pipe (b): local shapes {meta['shapes']}")
    losses, params, _ = ref
    same = list(got["losses"]) == list(losses) and all(
        np.array_equal(got[k], v) for k, v in params.items())
    if same:
        how = "bit-equal to one process, losses and parameters"
    else:
        loss_gap, param_gap = mesh_against_one("pipe", got, ref,
                                               mesh_config().lr)
        how = (f"not bit-equal to one process: losses within "
               f"{loss_gap:.3e}, parameters within {param_gap:.3e} where "
               f"held (phase 39's limits); each rank runs the one-process "
               f"step on the whole batch, so a gap is another summation "
               f"order of the same kernels")
    print(f"[pipe] (b) 'pipe' over 2 processes on this card (gloo), "
          f"flagship f32 B=64, nothing split ({meta['shapes']}): "
          f"{MESH_STEPS} losses {got['losses'].tolist()} {how}; ms a global "
          f"step " + ", ".join(f"{v:.1f}" for v in got["ms"])
          + f"; launches a step {TRAIN_WANT} on rank 0; {smi}")
    # (a) the pipelined flagship encoder, (c) the MoE one
    ranks = runs["pipeline"]["meta"]
    ticks = PIPE_M + 2 - 1
    for tag, amp in (("f32", False), ("bf16", True)):
        tol = PIPE_TOL[amp]
        for r in ranks:
            a = r[tag]
            k5 = Counts.full({"K5": ticks})
            k6 = Counts.full({"K6": ticks})
            rows = PIPE_B // PIPE_M * 8
            if a["fwd"] != k5 or a["bwd"] != k6 or any(
                    t != [rows, 845] for t in a["k5"]):
                fail(f"pipe (a) {tag}: rank {r['rank']} launched "
                     f"{a['fwd']} in the forward, {a['bwd']} in the "
                     f"backward, K5 at {a['k5']}")
            x_ok = a["x_err"] <= tol if r["rank"] == 0 else a["x_err"] == 0
            if a["forward_err"] > tol or a["grad_err"] > tol or not x_ok:
                fail(f"pipe (a) {tag}: rank {r['rank']} forward error "
                     f"{a['forward_err']:.3e}, leaf gradients "
                     f"{a['grad_err']:.3e}, input gradient "
                     f"{a['x_err']:.3e} (limit {tol:g})")
        r0 = ranks[0][tag]
        total = {n: total[n] + r0["fwd"][n] + r0["bwd"][n] for n in total}
        print(f"[pipe] (a) {tag}: the flagship encoder (d_model 512, 8 "
              f"heads, d_ff 2048, 2 layers) over 'pipe' 2 (gloo, this "
              f"card), B={PIPE_B} T=845 M={PIPE_M}: forward within "
              + " / ".join(f"{r[tag]['forward_err']:.3e}" for r in ranks)
              + " of the sequential encoder (x max|out|), each stage's "
              f"{r0['leaves']} leaf gradients within "
              + " / ".join(f"{r[tag]['grad_err']:.3e}" for r in ranks)
              + f", the input's within {r0['x_err']:.3e} (stage 1's "
              f"{ranks[1][tag]['x_err']:g}); launches a rank: K5 "
              f"{ticks} a forward at (rows, T) {r0['k5'][0]}, K6 {ticks} "
              f"a backward; forward + backward ms pipelined "
              + ", ".join(f"{v:.1f}" for v in r0["ms"])
              + f" (median {np.median(r0['ms']):.1f}) against the "
              f"sequential encoder's "
              + ", ".join(f"{v:.1f}" for v in r0["seq_ms"])
              + f" (median {np.median(r0['seq_ms']):.1f}) in one process; "
              f"{smi}")
    for r in ranks:
        m = r["moe"]
        if "load-balance" not in m["raised"] or not m["finite"] or \
                abs(m["aux"] - m["want_aux"]) > 1e-5 * abs(m["want_aux"]) \
                or m["forward_err"] > PIPE_TOL[False] or \
                m["launches"] != Counts.full({"K5": ticks, "K6": ticks}):
            fail(f"pipe (c): rank {r['rank']}: {m}")
    m = ranks[0]["moe"]
    total = {n: total[n] + m["launches"][n] for n in total}
    print(f"[pipe] (c) the MoE flagship encoder (8 experts) over 'pipe' "
          f"2 in training, f32, M={PIPE_M}: aux {m['aux']:.7g} against the "
          f"mean over microbatches of the sequential layers' summed aux "
          f"{m['want_aux']:.7g}, output within {m['forward_err']:.3e}, "
          f"the backward of sum(sin(out)) + aux finite; training without "
          f"return_aux raises ValueError ('load-balance'); launches a rank "
          f"{m['launches']}")
    t3 = time.perf_counter()
    snap = pipe_snapshot(smi)
    total = {n: total[n] + snap[n] for n in total}
    print(f"[pipe] phase 41: one-process reference {t1 - t0:.1f} s, (a) + "
          f"(b) + (c) in one pair of processes {t2 - t1:.1f} s, (d) "
          f"{time.perf_counter() - t3:.1f} s; launches {total}")
    return total


# ---- phase 42: use_flash_attention (K9, K10b, K10a) --------------------------
# (shape, BH, T, dk) of the kernel checks (k): the flagship's attention, the
# wider heads of the gate, PatchTST's encoder chunk and the EigenWorms shape
FLASH_SHAPES = (("flagship", 512, 845, 64), ("dk 128", 256, 845, 128),
                ("dk 256", 128, 845, 256), ("PatchTST chunk", 15616, 105, 64),
                ("EigenWorms", LONG_BH, LONG_T, LONG_DK))
FLASH_TOL = 2e-2   # x max|want|, as K6's bf16 limit: outputs rounded to
# bf16, the online softmax's rounding of unnormalised probabilities, di
# from the bf16 output
FLASH_WANT = {"K1": 6, "K2": 6, "K9": 2, "K10a": 2, "K10b": 2}   # (a)
FLASH_STEPS = 5    # (a): eager steps, each followed by the graph step
FLASH_LONG_STEPS = 3   # (c): steps of the EigenWorms-shaped model
STOCK = "jax/experimental/pallas/ops/tpu/flash_attention.py"   # the TPU
# kernels, reached from sie_tpu/models/layers.py:119 (`_flash`)


def sdpa_ms(q, k, v, do, scale: float, reps: int, flash: bool) -> tuple:
    """(forward ms, backward ms) of F.scaled_dot_product_attention on the
    same bf16 inputs, with the flash backend forced (flash) or PyTorch's
    own choice of backend, or (None, None) where the flash backend refuses
    the shape."""
    import contextlib
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    bh, t, dk = q.shape
    q4, k4, v4 = (z.view(1, bh, t, dk).detach().requires_grad_()
                  for z in (q, k, v))
    try:
        with (sdpa_kernel(SDPBackend.FLASH_ATTENTION) if flash
              else contextlib.nullcontext()):
            fwd = events_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, scale=scale), reps=reps)
            out4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
            bwd = events_ms(lambda: torch.autograd.grad(
                out4, (q4, k4, v4), do.view(1, bh, t, dk),
                retain_graph=True), reps=reps)
    except RuntimeError as exc:
        if not flash:
            raise
        print(f"[flash] SDPA's flash backend refuses BH {bh} T {t} dk {dk}: "
              f"{str(exc).splitlines()[0]}")
        return None, None
    return fwd, bwd


def flash_kernel_rows() -> tuple:
    """(k) K9, K10b and K10a against their plain versions at FLASH_SHAPES
    (the first LONG_HEADS heads at T 17984, the chunked plain versions):
    outputs, gradients, the row log-sum-exp and di; the backward run twice
    bit for bit; CUDA-event ms of each kernel beside its bound, the plain
    versions' and SDPA's, forward and backward, with the flash backend
    forced and with PyTorch's own choice. Returns the three rows of the
    kernels line, timed at the flagship's shape (library_ms: SDPA's flash
    backend)."""
    from sie_tpu_torch.ops.flash import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_bwd_plain, flash_attention_plain, flash_delta_plain,
        flash_fwd, flash_lse_plain)
    gen = torch.Generator(device="cuda").manual_seed(42)
    err = [0.0, 0.0, 0.0]   # max abs: K9's output, K10a's dQ, K10b's dK/dV
    rows = None
    for tag, bh, t, dk in FLASH_SHAPES:
        q, k, v, do = (torch.randn((bh, t, dk), generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        scale, hd = 1.0 / dk ** 0.5, (LONG_HEADS if t > 4096 else bh)
        o, lse = flash_fwd(q, k, v, scale, want_lse=True)
        o2, lse2 = flash_fwd(q, k, v, scale, want_lse=True)
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            fail(f"K9 {tag}: two runs differ")
        del o2, lse2
        bwd_dkv = lambda: flash_attention_bwd_dkv(q, k, v, o, do, lse, scale)
        dkk, dv, delta = bwd_dkv()
        bwd_dq = lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                scale)
        dq = bwd_dq()
        if not (all(torch.equal(a, b) for a, b in zip((dkk, dv, delta),
                                                      bwd_dkv()))
                and torch.equal(dq, bwd_dq())):
            fail(f"K10 {tag}: two runs differ")
        sub = lambda z: z[:hd]
        want_o = flash_attention_plain(q[:hd], k[:hd], v[:hd], scale)
        want_d = flash_delta_plain(sub(o), sub(do))
        wants = flash_attention_bwd_plain(q[:hd], k[:hd], v[:hd], do[:hd],
                                          want_d, scale)
        errs = {}
        for name, got, want in (("out", o, want_o), ("dq", dq, wants[0]),
                                ("dk", dkk, wants[1]), ("dv", dv, wants[2])):
            scl = float(want.float().abs().max())
            e = float((sub(got).float() - want.float()).abs().max())
            errs[name] = e
            if not e <= FLASH_TOL * scl:
                fail(f"flash {tag} {name}: max abs err {e} > {FLASH_TOL} x "
                     f"{scl}")
        e_lse = float((sub(lse) - flash_lse_plain(q[:hd], k[:hd], scale))
                      .abs().max())
        e_d = float((sub(delta) - want_d).abs().max())
        if not e_lse <= 1e-3 or not e_d <= 1e-3 * float(want_d.abs().max()):
            fail(f"flash {tag}: log-sum-exp err {e_lse}, di err {e_d}")
        del want_o, wants, want_d
        err = [max(err[0], errs["out"]), max(err[1], errs["dq"]),
               max(err[2], errs["dk"], errs["dv"])]
        long = t > 4096
        reps = 3 if long else 10
        ms9 = events_ms(lambda: flash_fwd(q, k, v, scale, want_lse=True),
                        reps=reps)
        ms10b = events_ms(bwd_dkv, reps=reps)
        ms10a = events_ms(bwd_dq, reps=reps)
        plain9 = events_ms(lambda: flash_attention_plain(q, k, v, scale),
                           reps=1, warmup=0)
        plain10 = events_ms(lambda: flash_attention_bwd_plain(
            q, k, v, do, delta, scale), reps=1, warmup=0)
        lib9, lib10 = sdpa_ms(q, k, v, do, scale, reps, flash=True)
        def9, def10 = sdpa_ms(q, k, v, do, scale, reps, flash=False)
        # bytes: each input read once, each output written once; (BH, T)
        # f32 rows: lse, di
        io, r4, fl = bh * t * dk * 2, 4 * bh * t, bh * t * t * dk
        b9 = bound_ms(4 * io + r4, 4 * fl, PEAK_BF16)
        b10b = bound_ms(7 * io + 2 * r4, 8 * fl, PEAK_BF16)
        b10a = bound_ms(5 * io + 2 * r4, 6 * fl, PEAK_BF16)
        print(f"[flash] {tag} (BH={bh} T={t} dk={dk}): K9 {ms9:.4f} ms "
              f"(bound {b9[0]:.4f}, {b9[1]}; plain {plain9:.3f}; SDPA flash "
              f"{lib9}, SDPA default {def9:.4f}), K10b {ms10b:.4f} ms (bound "
              f"{b10b[0]:.4f}, {b10b[1]}), K10a {ms10a:.4f} ms (bound "
              f"{b10a[0]:.4f}, {b10a[1]}); plain backward {plain10:.3f} ms, "
              f"SDPA flash backward {lib10} ms, SDPA default backward "
              f"{def10:.4f} ms; max abs err out/dq/dk/dv "
              + "/".join(f"{errs[n]:.3e}" for n in ("out", "dq", "dk", "dv"))
              + f" (first {hd} rows of BH), lse {e_lse:.2e}, di {e_d:.2e}")
        if rows is None:   # the flagship's shape
            rows = [
                {"name": "K9 flash_fwd", "source":
                 "sie_tpu_torch/csrc/flash_fwd.cu", "replaces":
                 f"{STOCK}:758", "ms": ms9, "plain_ms": plain9,
                 "bound_ms": b9[0], "bound_by": b9[1], "library_ms": lib9},
                {"name": "K10a flash_bwd_dq", "source":
                 "sie_tpu_torch/csrc/flash_bwd.cu", "replaces":
                 f"{STOCK}:1456", "ms": ms10a, "plain_ms": plain10,
                 "bound_ms": b10a[0], "bound_by": b10a[1],
                 "library_ms": lib10},
                {"name": "K10b flash_bwd_dkv", "source":
                 "sie_tpu_torch/csrc/flash_bwd.cu", "replaces":
                 f"{STOCK}:1121", "ms": ms10b, "plain_ms": plain10,
                 "bound_ms": b10b[0], "bound_by": b10b[1],
                 "library_ms": lib10}]
        del q, k, v, do, o, lse, dkk, dv, delta, dq
    for row, e in zip(rows, err):
        row.update(route="cuda", max_abs_err=e)
    return tuple(rows)


def flash_flagship(smi: str) -> dict:
    """(a) The flagship with `use_flash_attention` (bench_kernel.py's
    dnn_flash: dropout 0, amp, B 64): eager steps against the captured
    staged steps, bit for bit, K1 6, K2 6, K9 2, K10a 2, K10b 2 a step and
    no K5 or K6 (counts zeroed just before, read just after); the first
    loss and the gradients against the CPU plain path; replays' median
    and idle share beside the same model without the flag (K5, K6)."""
    cfg = train_config(use_flash_attention=True)
    ds = random_rows(cfg, 4 * cfg.batch_size)
    sched = schedule(cfg, len(ds.y), 4)
    counts = Counts()
    counts.zero()   # the path's main run
    graph_against_eager(cfg, ds, sched, FLASH_STEPS, FLASH_WANT, "flash",
                        True, stats=False)
    launches = counts.read()
    print(f"[flash] (a) launches over the run {launches}")
    against_cpu(cfg, ds, "flash", grads=True)
    on_ms, on_idle = replay_ms(cfg, ds, sched, "flash")
    off_ms, off_idle = replay_ms(train_config(), ds, sched, "flash/off")
    print(f"[flash] (a) replayed step with the flag (K9, K10) {on_ms:.3f} ms "
          f"(idle {on_idle:.3f}) against without it (K5, K6) {off_ms:.3f} ms "
          f"(idle {off_idle:.3f}); {smi}")
    return launches


def flash_dropout() -> tuple:
    """(b) The flagship with the flag at dropout 0.1: training takes the
    fused branch (K5 2, K6 2 a step: the flash gate wants rate 0), and its
    Predictor, in eval, the flash branch (K9 2 and K1 6 a request of 64
    rows, no K5); 2 rows against the CPU plain path. Returns (the step's
    launches, the request's)."""
    from sie_tpu_torch.serve import Predictor
    cfg = train_config(use_flash_attention=True, dropout=RATE)
    ds = random_rows(cfg, 2 * cfg.batch_size)
    trainer = seed0_trainer(cfg)
    dev = trainer.device_data("train", ds)
    counts = Counts()
    counts.zero()
    loss, _ = trainer.train_step_indexed(dev, np.arange(cfg.batch_size),
                                         np.ones(cfg.batch_size, np.float32),
                                         1.0)
    step = counts.read()
    if step != Counts.full(TRAIN_WANT) or not np.isfinite(float(loss)):
        fail(f"flash dropout {RATE} step: launches {step}, loss "
             f"{float(loss)}")
    model = seed0_trainer(cfg).model
    pred = Predictor.from_module(cfg, model, device="cuda", max_batch=64)
    pred.predict(ds.x[:64])   # warm-up
    counts.zero()
    t0 = time.perf_counter()
    out = pred.predict(ds.x[:64])
    ms = 1e3 * (time.perf_counter() - t0)
    served = counts.read()
    if served != Counts.full({"K1": 6, "K9": 2}):
        fail(f"flash dropout {RATE}: a request of 64 rows launched {served}")
    cpu = Predictor.from_module(cfg, copy.deepcopy(model).cpu(),
                                device="cpu", max_batch=64).predict(ds.x[:2])
    e = float(np.abs(out.logits[:2] - cpu.logits).max())
    if not e <= SERVE_TOL or not (out.classes[:2] == cpu.classes).all():
        fail(f"flash dropout {RATE}: served logits differ from the CPU plain "
             f"path by {e}")
    print(f"[flash] (b) dropout {RATE}: a training step (loss "
          f"{float(loss):.4f}) launched {step}; a request of 64 rows "
          f"{ms:.3f} ms launched {served}; 2 rows within {e:.3e} of the CPU "
          f"plain path")
    return step, served


def flash_long() -> dict:
    """(c) The EigenWorms-shaped InterpGN + Transformer (`long_config`) in
    amp with the flag at the default fused_attention_max_len 4096, where
    the plain branch's f32 scores would take 8 x 8 x 17984^2 x 4 bytes:
    FLASH_LONG_STEPS steps, each K1 = K2 = the strided banks' components,
    K9 2, K10a 2, K10b 2, a finite loss and moved weights; peak memory."""
    cfg = long_config().replace(amp=True, use_flash_attention=True,
                                fused_attention_max_len=4096)
    want = dict(strided_launches(cfg, "flash long"), K9=2, K10a=2, K10b=2)
    ds = random_rows(cfg, 2 * cfg.batch_size)
    torch.cuda.reset_peak_memory_stats()
    _, _, _, times, losses, launches = train_steps(
        cfg, ds, want, 0, FLASH_LONG_STEPS, "flash long")
    plain = cfg.batch_size * cfg.n_heads * cfg.seq_len ** 2 * 4
    print(f"[flash] (c) EigenWorms-shaped, amp, the flag: steps "
          + ", ".join(f"{t:.1f}" for t in times) + " ms, losses "
          + ", ".join(f"{l:.4f}" for l in losses) + f"; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, against "
          f"{plain / 1e9:.1f} GB for the plain branch's f32 scores alone")
    return launches


def phase_flash(smi: str) -> tuple:
    """Phase 42: (k), (a), (b) and (c). Returns (K9, K10a, K10b rows, the
    launches by path)."""
    t0 = time.perf_counter()
    rows = flash_kernel_rows()
    t1 = time.perf_counter()
    trained = flash_flagship(smi)
    t2 = time.perf_counter()
    dropout_step_counts, served = flash_dropout()
    t3 = time.perf_counter()
    long = flash_long()
    print(f"[flash] phase 42: (k) {t1 - t0:.1f} s, (a) {t2 - t1:.1f} s, (b) "
          f"{t3 - t2:.1f} s, (c) {time.perf_counter() - t3:.1f} s; "
          f"dropout {RATE} step {dropout_step_counts}")
    return rows, {"flash": trained, "flash_serve": served,
                  "flash_long": long}


def lap(what: str) -> None:
    """Prints the seconds since the previous lap (a phase's time) and since
    the start."""
    now = time.perf_counter()
    print(f"[time] {what}: {now - lap.last:.1f} s (at {now - lap.start:.1f} "
          f"s)", flush=True)
    lap.last = now


def main() -> None:
    import tempfile
    lap.last = lap.start = time.perf_counter()
    smi = phase_device()
    lap("device")
    phase_build()
    lap("build")
    k1 = phase_k1()
    lap("k1")
    with time_limit(300, "the K5 phase"):
        k5 = phase_k5()
        lap("k5")
    served, serve_launches = phase_serve()
    lap("serve")
    with time_limit(300, "the K5 dropout phase"):
        phase_k5_dropout()
        lap("k5_dropout")
    k2 = phase_k2()
    lap("k2")
    with time_limit(300, "the K6 phase"):
        k6 = phase_k6()
        lap("k6")
    launches = phase_train()
    lap("train")
    k3, k4 = phase_k3_k4()
    lap("k3_k4")
    fused, fused_serve = phase_fused(served)
    lap("fused")
    del served
    with time_limit(600, "the long-sequence K5/K6 phase"):
        k7, k8a, k8b = phase_long_attention()
        lap("long_attention")
    long_launches = phase_train_long()
    lap("train_long")
    phase_graphs(smi)
    lap("graphs")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_cli(work)
        lap("cli")
        uea_fcn = phase_uea("FCN", UEA_STEPS, True, "uea_fcn")
        lap("uea_fcn")
        uea_resnet = phase_uea("ResNet", RESNET_STEPS, False, "uea_resnet")
        lap("uea_resnet")
        phase_eegcnn(smi)
        lap("eegcnn")
        cli_uea = phase_cli_bn()
        lap("cli_bn")
        with time_limit(600, "the serving phases"):
            pred, bundle_dir, xs, bundle_ms, bundle = phase_bundle(work)
            lap("bundle")
            phase_http(work, pred, bundle_dir, xs, bundle_ms)
            lap("http")
            exported = phase_export(work, pred, xs)
            lap("export")
        with time_limit(600, "the phases of run.py's other options"):
            augmented = phase_augment(smi)
            lap("augment")
            regression = phase_regression(work)
            lap("regression")
            phase_torch_ckpt(work)
            lap("torch_ckpt")
            loso = phase_loso(work)
            lap("loso")
        with time_limit(600, "the PatchTST and TimesNet phases"):
            backbones = {"patchtst": phase_patchtst(smi)}
            lap("patchtst")
            backbones["timesnet"] = phase_timesnet(smi)
            lap("timesnet")
            by_cli = phase_backbone_cli(work)
            lap("backbone_cli")
        with time_limit(600, "the streaming and task phases"):
            streamed, forecast_long = phase_stream_and_tasks(work, smi)
            lap("stream_and_tasks")
        with time_limit(600, "the MoE, variant and extra-family phases"):
            moe, variants, extra_experts = phase_extra(work, smi)
            lap("extra")
        with time_limit(300, "the ensemble phases"):
            ensemble, ensemble_uea = phase_ensembles(work, smi)
            lap("ensembles")
        with time_limit(300, "the mesh phase"):
            mesh = phase_mesh(work, smi)
            lap("mesh")
        with time_limit(300, "the seq and expert phase"):
            seq, expert = phase_seq_expert(work, smi)
            lap("seq_expert")
        with time_limit(120, "the pipe phase"):
            pipe = phase_pipe(work, smi)
            lap("pipe")
        with time_limit(300, "the flash phase"):
            (k9, k10a, k10b), flash = phase_flash(smi)
            lap("flash")
    finally:
        for proc in list(CHILDREN):
            stop_server(proc)
        shutil.rmtree(work, ignore_errors=True)
    # each row's launches: the timed training steps of its own path, and
    # the runs of the other paths that launch it (launches_by_path)
    options = {"augment": augmented, "regression": regression,
               "loso": loso, "stream": streamed}
    sbm_paths = {**backbones, "cli_patchtst": by_cli["PatchTST"],
                 "cli_timesnet": by_cli["TimesNet"], "moe": moe,
                 "variants": variants, "extra_experts": extra_experts,
                 "ensemble": ensemble, "ensemble_uea": ensemble_uea,
                 "mesh": mesh, "seq": seq, "expert": expert, "pipe": pipe}
    others = {"K1": {"uea_fcn": uea_fcn, "uea_resnet": uea_resnet,
                     "cli_uea_fcn": cli_uea, "serve": serve_launches,
                     "serve_bundle": bundle, "serve_export": exported,
                     **options, **sbm_paths},
              "K2": {"uea_fcn": uea_fcn, "uea_resnet": uea_resnet,
                     "cli_uea_fcn": cli_uea, **options, **sbm_paths},
              "K3": {"serve_fused": fused_serve},
              "K5": {"serve": serve_launches, "serve_bundle": bundle,
                     "serve_export": exported, **options,
                     "forecast_long": forecast_long, "moe": moe,
                     "ensemble": ensemble, "mesh": mesh, "seq": seq,
                     "expert": expert, "pipe": pipe},
              "K6": {**options, "forecast_long": forecast_long, "moe": moe,
                     "ensemble": ensemble, "mesh": mesh, "seq": seq,
                     "expert": expert, "pipe": pipe},
              # phase 42: (a) is their training path; (b)'s request, (c)
              "K9": {p: flash[p] for p in ("flash_serve", "flash_long")},
              "K10a": {"flash_long": flash["flash_long"]},
              "K10b": {"flash_long": flash["flash_long"]}}
    paths = ((k1, launches, "K1"), (k2, launches, "K2"),
             (k3, fused, "K3"), (k4, fused, "K4"), (k5, launches, "K5"),
             (k6, launches, "K6"), (k7, long_launches, "K5"),
             (k8a, long_launches, "K6"), (k8b, long_launches, "K6"),
             (k9, flash["flash"], "K9"), (k10a, flash["flash"], "K10a"),
             (k10b, flash["flash"], "K10b"))
    kernels = []
    for d, counted, key in paths:
        d["launches"] = counted[key]
        if not d["launches"]:
            fail(f"{d['name']} was not launched on its path")
        if d not in (k7, k8a, k8b) and key in others:
            by_path = {p: c[key] for p, c in others[key].items()}
            if not all(by_path.values()):
                fail(f"{d['name']} was not launched on every path: "
                     f"{by_path}")
            d["launches_by_path"] = {"train": counted[key], **by_path}
            d["launches"] += sum(by_path.values())
        kernels.append(d)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {k: d[k] for k in keys + ("launches_by_path",) if k in d}
        for d in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == [K2_LIB_FLAG]:
        k2_library_child(int(sys.argv[2]), int(sys.argv[3]))
    elif sys.argv[1:2] == [MESH_FLAG]:
        mesh_rank(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == [CLI_PROBE_FLAG]:
        cli_probe(sys.argv[2:])
    else:
        main()
