#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (monolith_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 (it
needs one card and exits non-zero without CUDA). Phases, none of whose
failures is caught:

  1. the card's name and power limit (nvidia-smi);
  2. build the host library (g++) and each kernel library (one nvcc per
     CUDA source, sm_90a) from the checkout's sources, all in parallel;
  3. K1 (gather_rows) and K2 (scatter_rows) against their plain versions at
     each path's shapes (DeepFM: pool [2^21, 128] f32, 32768 rows;
     multislot bf16: pool [17 x 2^18, 128] bf16, 49152 rows; ~10% of rows
     -1), and K3 (stochastic_round_bf16) at [49152, 128] f32: bit-exact;
     each timed (kernel, plain version, one library call) beside its bound,
     by CUDA events around each launch after an L2 flush; beside that the
     event floor (an empty kernel timed the same way). K3's earlier
     one-group design (csrc/baselines/rounding_one_group.cu, built beside
     the kernels and on no path) is held bit for bit against the same
     plain version and timed in turns with K3, beside an empty kernel on
     K3's grid;
  3b. K1 and K2 against their plain versions, bit for bit, at the lengths
     phase 10 gives them on the same pools: a sync round's power-of-two
     lengths with a -1 tail (2^15, 2^18, 2^20 rows), a delta's and an
     export's ragged lengths with -1 inside (294,838, 504,203 and, on the
     bf16 pool, 540,468 rows);
  4. the DeepFM path: full-width DeepFM (bench.py's deepfm config:
     capacity 2^21, unique_cap 32768, batch 8192, hidden (256, 128, 64))
     through Trainer.train_step for 4 steps and Trainer.evaluate for 1
     batch, with the kernels' launch counts read right after;
  5. the multislot bf16 path: bench.py's multislot config with
     MT_BENCH_DTYPE=bf16 at full width (16 + 1 tables merged into one bf16
     pool of 17 x 2^18 rows, stochastic rounding, 40 slots + a 20-long
     DIN history, bf16 dense tower (256, 128, 64), unique_cap 49152, batch
     8192), 4 train steps and 1 eval batch, launch counts read right
     after;
  5b. the DeepFM block path: the same DeepFM config with
     steps_per_dispatch=8: one train_step, then 3 blocks of 8 through
     stage_block + train_step_block(..., staged=...) in bench.py's order
     (block k+1 staged right after block k is dispatched), then 1 eval
     batch; launch counts K1 = 1 + 24 + 1, K2 = 1 + 24; finite losses
     that agree with phase 4's over the steps both ran (the stream hardly
     repeats an id in 25 steps, so the loss stays at 0.696 and cannot be
     asked to fall); every train_step_block runs with PyTorch's synchronisation
     check set to raise; a staged block dispatched out of turn raises;
  5c. the multislot bf16 asynchronous block path: the same multislot
     config with async_optimize=True, same shape of run; K1 = 1 + 2*24 + 1
     (two gathers a step of a block), K2 = K3 = 1 + 24 (the first step of
     a block has no pending write-back and launches none; the last
     step's lands at the end of its block); finite, falling losses whose
     first two agree with phase 5's;
     both block phases print ms per step of the block path and of the
     per-step path in the same trainer, and from a recording of the
     program's spans over the blocks the host prepare and batch copy per
     step and the upload's start per block;
  5d. the block on the card against the block on the CPU from one carried
     state: a small DeepFM with its vector segment under DC, clip_norm
     0.05 and init_scale 0.0, synchronous and asynchronous (losses rtol
     1e-4, live pool rows rtol 1e-4 / atol 1e-5), and the small multislot
     bf16 variant, asynchronous (losses rtol 1e-3);
  6. small trainers on the card and on the CPU from one carried state,
     3 steps each: DeepFM f32 losses agree to rtol 1e-4; the multislot
     bf16 variant (bf16 pools, stochastic rounding, bf16 tower) to rtol
     1e-3;
  7. the multislot bf16 bench variant at the JAX package's test size
     trained on the card for 41 steps: train AUC > 0.515;
  8. the port's NORTHSTAR (6000 steps, batch 1024, data seed 7) trained on
     the card: eval AUC inside NORTHSTAR_BAND;
  9. each kernel's own duration from a torch.profiler window over 20
     flushed launches at phase 3's shapes, read by kernel name (last, so
     that no timed phase runs after the profiler has been on); for each
     K3 entry (and its ragged shapes) K3 and the one-group design in turns,
     the empty kernel on K3's grid and x.to(bf16), after the protocol's
     flush and after one that reads (lines "K3 redesigned [<path>] ...");
 10. the model's way out of the trainer, at full width, run before phases
     5d-9 on the trainers that phases 5b and 5c leave (the DeepFM one
     records touched ids from its first step):
     10a. checkpoint: save the DeepFM trainer (1 GiB pool), restore into a
       fresh one: pools, host store, dense parameters, accumulators and
       step equal bit for bit, and the next train_step on a batch of known
       ids gives the same loss (rtol 1e-6); seconds, bytes on disk, rows;
     10b. export and serve: export_model -> ServingModel on the card
       (unique_cap 32768): every exported row equals the trainer's, read
       by K1's plain version; 8 predicts at batch 8192 from the same stream:
       finite, [8192], equal to the trainer's eval predictions (rtol 1e-4,
       atol 1e-5); K1 = one export gather a table + one a trainer eval; load
       seconds, pool bytes, ms per predict (median) split into host prepare
       / device / readback. The same for the multislot
       bf16 trainer (17 merged tables, bf16 pool exported as f32,
       unique_cap 49152), 4 predicts (rtol 1e-3: bf16 tower);
     10c. streaming push: StreamingTrainer with a stand-in sync target
       that calls ServingModel.apply_delta, 16 steps, a round every 8: K1's
       count rises by one a step and one a non-empty gather, every pushed
       fid's serving row equals the trainer's as K1's plain version reads
       it, a predict after the push differs from one before;
     10d. delta and hot swap: save_delta (K1; the saved values equal the
       plain version's) -> restore_delta into 10a's restored trainer (K1 +
       K2): its pool equals, bit for bit, a copy of the pool from before
       that the plain versions updated with the same rows and values; 8
       more steps, a second export, reload_export: step and predictions
       follow it;
     10e. a small ServingModel on the card and on the CPU from one export:
       predictions rtol 1e-5;
 11. expiry and tiered storage on the deepfm_f32 cell with a ttl of 8,
     ts = step, run after phase 10:
     11a. 16 steps, evict_expired(8): every freed row reads zero by K1 and
       by its plain version, the surviving rows are bit for bit as they
       were, the store shrank by the freed count, and in the next step the
       new ids on recycled rows get init values (read from what
       fused_lookup hands the model); 4 steps with finite losses; rows
       freed, host ms of the eviction, the zeroing K2's length and ms;
     11b. the same tiered: spill_expired(8) archives what the plain gather
       reads, bit for bit, and zeroes the rows; 2 steps whose user ids are
       spilled ids revive them, and every revived row handed to the model
       is its archived state bit for bit; a checkpoint round trip keeps the
       archive; rows spilled, spill seconds, archive bytes, revived rows a
       step, upload bytes a step, tiered against untiered ms/step and host
       prepare (prepare_batch + pack_wire against prepare_wire);
     11c. a small tiered DeepFM on the card and on the CPU from one state
       (train, spill, other ids, revive, train): pools rtol 1e-5, archives,
       stores and counters equal;
 12. the front door at full width, run after phase 11, through the entry
     points a user calls (`train.main(argv)` in this process, so that the
     launch counts see it):
     12a. 8 batches of bench.py's deepfm stream (SyntheticCTR(1,000,000
       users, 200,000 items, batch 8192, seed 0)) as 65,536 Examples in a
       framed mtex file, and the first batch as one pb_example_batch
       record (pb_compat); both read back through FileSource +
       BatchedDataset equal the generator's batches; host ms to write and
       a batch to read, by format;
     12b. `train.main` with bench.py's deepfm config on the file (6 steps
       in blocks of 3, 2 eval batches, the Estimator's checkpoint, an
       export): finite losses, CHECKPOINT at step 6, the export served by
       a ServingModel on the card; K1 = 6 + 2 + 1 (export), K2 = 6; ms/step
       of the CLI's train loop beside the same trainer alone on the
       batches in memory, and prepare_wire's ms a batch;
     12c. `train.main --mode eval` restores step 6 through the Estimator
       and evaluates the file's first 2 batches: loss and AUC equal a
       direct checkpoint.restore + Trainer.evaluate to 1e-6 relative;
     12d. README's real-data command (`--task movie_ranking --data
       movielens:examples/movielens/ratings.dat --mode train_and_eval
       --steps 800 --batch_size 512`): ms/step, examples/s, eval AUC;
       K1 = 2 x (800 + 50), K2 = 2 x 800; the JAX package's frozen
       MovieRanking configuration (parity.py) trained on the card: eval AUC
       within PARITY_BAND of JAX_PARITY_AUC; then K1/K2 at the CLI's shapes
       (the user table's pool [2^17, 128] f32 and its 8192 rows of the last
       step) as in phase 3, entries with `launches_by_path["cli"]`.
 13. the realtime loop over localhost gRPC at full width, run after phase
     12 on a fresh deepfm_f32 trainer that records touched ids (4 steps,
     then an export; every kernel launch of 13a-13d counted as path
     "realtime"):
     13a. a ServingAgent on the card registers in a FileDiscovery; a
       SyncClientManager finds it there; StreamingTrainer runs 24 steps
       with a round every 8 (100k-250k rows a round, several requests of
       at most 4 MiB each): every ack equals the rows pushed (no -1), every
       pushed fid's row in the agent's model equals the trainer's as K1's
       plain version reads it, K1 = steps + non-empty gathers, K2 = steps;
       a ServingClient predict at batch 8192 equals the in-process predict
       (rtol 1e-6) and differs from one before the push; ms a round and
       rows/s over gRPC beside an in-process round on the same trainer, ms
       a predict over gRPC beside in-process;
     13b. two row-shard ServingModels on the card, each behind an agent,
       and a ShardedServingRouter (unique_cap 32768) over two
       ServingClients: shard sizes sum to the single model's, 3 predicts at
       batch 8192 equal the single ServingModel's exactly, push_routed of
       4,096 rows lands each row on its owning shard only; ms a routed
       predict beside the single model's;
     13c. 8 more steps and a second export: VersionWatcher.poll_once swaps
       the agent's model, predicts over gRPC follow the new export, a push
       after the swap applies; a TrainingController over a
       ControllerClient: status (step, table size), pause and resume around
       a `train` call on another thread, SaveCheckpoint honoured at the
       next hook;
     13d. `demo.main(["--realtime", "--model_dir", tmp])` at its defaults on
       the card: a pushed row count > 0, K1 = 500 + 20 + 1 + 100 +
       non-empty gathers, K2 = 600.
 14. the model zoo at full width, run after phase 13, for each of six
     variants (ffm, din, din with seq_encoder="dien", mmoe, dcn, autoint)
     at the task's default widths with capacity_per_shard 2^21 and the
     deepfm_f32 engine (unique_cap = new_cap = 32768, batch 8192):
     14a. `train.main` on the CLI's synthetic data (seed 0): 8 steps one by
       one, 16 in blocks of 4 with the Estimator's checkpoint and an
       export, then `--mode eval` on 4 batches (K1 = 8 / 16 + 1 / 4, K2 =
       8 / 16); ms/step of the CLI's train loop;
     14d. a direct checkpoint.restore evaluates the same 4 batches as the
       CLI did (1e-6 relative), and a ServingModel on the card loaded from
       the export predicts a batch as the trainer does (rtol 1e-4); then
       2 + 8 + 8 train steps of the restored trainer on bench.py's deepfm
       stream: ms/step (host clock), device busy ms/step, idle share and
       device operations per step under torch.profiler, K1/K2 bit for bit
       against their plain versions on the trained pool and the last
       step's rows; every launch of 14a and 14d counted as path "zoo"
       (K1 52, K2 42 a variant);
     14b. tests/test_models.py's size on the card, 80 steps: the mean loss
       of the last 10 below the first 10's; DIN's eval AUC > 0.53; MMoE's
       per-task losses in aux;
     14c. that small model on the card and on the CPU from one carried
       state, 3 steps on batches of admitted ids: losses rtol 1e-4.
 15. the rest of the model library, run after phase 14, on the deepfm_f32
     configuration (DeepFMTask(embedding_dim=16, capacity_per_shard=2^21),
     unique_cap = new_cap = 32768, batch 8192, the deepfm_f32 stream) with
     DeepFM's module replaced by `library_task`'s: DCN(layer_num=2,
     use_dropout=True, keep_prob=0.9) beside Dense(256, kernel norm) ->
     BatchNorm -> relu -> LHUCTower((128, 64)) -> LayerNorm, Dense(1) on
     both; every launch of 15a and 15d counted as path "library":
     15a. for each dense optimizer (adagrad, adamom, adamom_v2, rmsprop_v2,
       shampoo): 8 train_steps and a block of 4 (finite losses, BatchNorm's
       running mean off zero); evaluate and two predicts leave the
       parameters, the optimizer's tree and model_state bit for bit and
       agree; checkpoint.save -> restore into a fresh trainer: pool,
       parameters, optimizer tree and model_state bit for bit, the next
       train_step of both equal bit for bit; export_model -> ServingModel
       with the statistics, predictions = trainer.predict (rtol 1e-4);
       ms/step (host clock, 4 steps), device busy ms/step and operations
       per step under torch.profiler (4 more); two train-mode forwards of
       one batch differ by step and repeat for the same step (dropout);
       K1 28, K2 22 an optimizer;
     15b. the module small (zero init, keep_prob 1.0) on the card and on
       the CPU from one carried state, 3 steps per optimizer: losses and
       batch_stats rtol 1e-4 (shampoo 1e-3); dropout drawn on the card:
       the kept share of an [8192, 51] draw within 4 sigma of 0.9, kept
       values exactly x / 0.9;
     15c. inbatch_auc_loss, batch_softmax_loss, make_loss_fn over the 8
       ranking losses ([1024, 8] lists with invalid labels),
       feature_insight (both modes) and fid_counter at batch 8192 on the
       card and on the CPU: values and input gradients rtol 1e-5 (atol 1e-5
       of each tensor's largest magnitude: batch sums that cancel);
     15d. tests/test_infra.py's compat task, built by compat.FeatureFactory
       at capacity 2^21, 8 steps (K1 18, K2 16 with the graph dump's
       lookup): dump_model is JSON, dump_graph text.
 16. the sharded trainer (parallel/sharded.py), run after phase 15; one
     card holds one NCCL rank (a world of 1 on an in-process store,
     cuda:0), so its collectives run at world 1 there:
     16a. deepfm_f32 at full width (init_scale 0.0) through ShardedTrainer,
       once for each exchange (allgather, a2a), beside the Trainer on the
       same batches: 8 steps, a synchronous and an asynchronous block of 8
       and 1 eval batch under torch's deterministic algorithms (index_add_
       in a fixed order), losses, pools and dense params within 1e-6 of
       the Trainer's (largest gap over the largest magnitude), eval equal;
       then with the default algorithms 8 timed steps beside the
       Trainer's, a timed block of 8, and 4 steps under torch.profiler:
       ms/step, device busy ms/step, device operations/step and the NCCL
       kernels' share of the busy time; K1/K2 bit for bit against their
       plain versions on the trained pool and the last step's rows;
     16b. multislot_bf16 at full width through ShardedTrainer (allgather),
       8 steps beside the Trainer's: finite losses, the bf16 pool's live
       rows by mean and standard deviation, K1/K2/K3 bit for bit on its
       pool and rows;
     16c. two gloo ranks on cuda:0 run each collective of the step on
       CUDA tensors (the probe), then the deepfm_f32 a2a step over two
       ranks sharing the card (capacity 2^20 a shard) for 8 steps, held
       against the same two ranks on the CPU within 1e-5 (losses, dense
       params, each shard's live rows by id); each rank a process of its
       own (`rank_16c`), K1 = K2 = 8 a card rank, counted with the path.
     Every launch of 16a and 16c is path "sharded" of the deepfm_f32
     kernels, 16b's of the multislot_bf16 ones.
 17. the multi-host trainer (parallel/multihost.py), run after phase 16:
     17c. first, two gloo ranks sharing cuda:0 (`rank_17c`, a process
       each, fed its half of every batch; capacity 2^20 a shard, tiered,
       ttl 8, touches recorded): 8 steps, a synchronous block of 8, an
       evaluation, expiry, a spill, 4 steps that revive, predict, export
       and a checkpoint by both ranks, a streaming round to a stand-in
       target; held against the same ranks on the CPU within 1e-5 (losses,
       eval, predictions, dense params and rows by id; freed, spilled and
       revived counts and pushed rows exactly); each rank holds its own
       store alone (its RSS growth for one store of capacity 2^20 beside
       what a ShardedTrainer rank's two take); every pushed row acked and
       equal to its pool row; K1 = 24 (+1 with a spill), K2 = 20 (+1 with
       a spill, +1 with freed rows) a card rank;
     17a. deepfm_f32 at full width (init_scale 0.0) on one NCCL rank (a
       world of 1; a2a#1 over a gloo group of 1) beside the Trainer: 8
       steps, a synchronous and an asynchronous block of 8 and 1 eval
       batch under deterministic algorithms, losses and dense params
       within rtol 1e-5 / atol 1e-6 and the pools by id; then with the
       default algorithms 8 timed steps in turns with the Trainer and 16a's
       a2a ShardedTrainer on the same batches, 4 steps with the host phases
       timed (local prepare, a2a#1, owner map, pack, upload), a timed
       synchronous and asynchronous block of 8, and 4 steps under
       torch.profiler (busy, operations, idle); K1/K2 bit for bit on its
       pool;
     17b. multislot_bf16 at full width, an asynchronous block of 8 beside
       the Trainer's: three all-to-alls a step (int32 ids, bf16 rows, bf16
       gradients), losses within 1e-3, live rows' mean and std within
       0.1%, K1/K2/K3 bit for bit on its pool;
     then 17c's checkpoint restored 2 -> 1 into a one-rank MultiHostTrainer
     and into the Trainer, equal by id to the ranks' rows, and its export
     served by one ServingModel, equal to the ranks' predict (rtol 1e-4);
     17d logs 17c's spill and revive: rows spilled, revived rows and bytes
     a step, the tiered ms/step. Every launch of 17a and 17c's card ranks
     is path "multihost" of the deepfm_f32 kernels, 17b's of the
     multislot_bf16 ones.
 18. the multi-array step and the structure-of-arrays state, run after
     phase 17:
     18a. multislot_bf16 with EngineConfig(packed="off") at full width
       (params [4456448, 17] bf16, Adagrad slots f32): the table state's
       bytes against the packed pool's; 8 steps in turns with the packed
       trainer on the same batches (ms/step of each), 4 under
       torch.profiler (device busy ms/step, operations/step); K3 once a
       step, K1 and K2 never; checkpoint restored into a
       structure-of-arrays trainer (bit for bit) and a packed one (params
       bit for bit, slots the f32 ones rounded to nearest bf16); export
       served by a ServingModel = the trainer's predict (rtol 1e-3: bf16
       tower, as 10b's multislot);
     18b. deepfm_f32 with compact_wire=False (int32 index matrices on the
       multi-array path) beside the wire Trainer, 8 steps under
       deterministic algorithms: losses, pools and dense params bit for
       bit; K1 and K2 once a step on both; upload bytes a step;
     18c. multislot_bf16 packed at batch 32768 with unique_cap = new_cap
       from utils/tuning.suggest_caps over the first 3 batches (about
       135,000): at least one step maps more than 65535 unique ids; 8
       steps: ms/step, host prepare_batch ms, upload bytes a step; K1, K2,
       K3 once a step;
     18d. a small structure-of-arrays multislot (bf16 table, stochastic
       rounding, f32 tower) and DeepFM (f32) on the card and on the CPU
       from one carried state, 3 steps: losses and f32 tables within
       1e-5, bf16 params within one bf16 ulp;
     18e. deepfm_f32 tiered as structure of arrays (ttl 8): 16 steps,
       spill_expired(8) (the freed rows read zero in params and every
       slot), 2 steps whose user ids were spilled: each revived row, as
       the forward reads it, equals its archived params and slots bit for
       bit; no kernel launched;
     18f. one NCCL rank of the structure-of-arrays ShardedTrainer = the
       structure-of-arrays Trainer bit for bit (8 steps, deterministic
       algorithms, deepfm_f32 width), then 16c's two gloo ranks sharing
       cuda:0 on that layout against two CPU ranks within 1e-5;
     then K3 on [49152, 17] f32 (18a's params, 4-element groups that
     straddle rows) and a ragged [13, 17], and K1/K2/K3 at 18c's shapes
     (the trained pool, the last step's rows), each against its plain
     version bit for bit and timed as phase 3, K3 beside its one-group
     design (entries of paths "soa" and "multi_array"). Every launch of
     18a, 18e and 18f counts as path "soa" of its config's kernels, of 18b
     and 18c as "multi_array".

 19. tiered storage and deltas on the sharded trainer, and the ranks that
     `parallel.launch` starts, run after phase 18, all on the deepfm_f32
     cell (batch 8192, embedding_dim 16, hidden (256, 128, 64), unique_cap
     = new_cap = 32768, init_scale 0.0, ttl 8, ts = step):
     19a. a tiered ShardedTrainer on one NCCL rank (capacity 2^21), each
       exchange, beside the tiered Trainer under deterministic algorithms:
       16 steps, spill_expired(8) (archived = K1's plain gather bit for
       bit, the rows zeroed), 2 steps and a synchronous block of 4 whose
       user ids were spilled (every revived row handed to the model is its
       archived state bit for bit), 1 eval batch: losses, spilled counts,
       pools and dense params bit for bit equal to the Trainer's; then
       save_delta restored into a fresh rank (rows equal by id) and a
       checkpoint with its archive restored into another (archive and live
       rows equal); K1 24 / K2 23 an exchange, the delta K1 2 / K2 1;
     19b. the same sequence on two gloo ranks sharing cuda:0 through
       `parallel.launch` (2^20 rows a shard), both exchanges, the delta
       restored into two fresh ranks: equal to the same two ranks on the
       CPU within 1e-5 (losses, dense params, each shard's live rows by
       id), spilled and revived counts exactly;
     19c. `train.rank_main` (train.main's body) under `launch(backend=
       "gloo", device="cuda:0")` with --num_shards 2 (2^20 rows a shard):
       6 steps, 2 eval batches, the per-shard checkpoint restored 2 -> 1
       into the Trainer, equal by id;
     19d. `dryrun_multichip` on one NCCL rank and on two gloo ranks sharing
       the card (K3 in its bf16 multislot);
     19e. `scaling_bench --gloo-one-card --sizes 1,2`: its lines and JSON.
     Each sub-phase prints ms/step (reviving steps apart), rows spilled
     and revived, delta bytes and seconds; the launches count as paths
     "sharded_tiered" (19a and 19b's card ranks), "delta" (their deltas)
     and "launch" (19c-19e's ranks and 19e's one-rank run; K3 under the
     multislot_bf16 entry).
 20. bench.py's default multislot (no MT_BENCH_DTYPE; profile_step's
     `multislot`): 16 + 1 tables merged into one f32 pool of [4456448,
     128], 2,281,701,376 B, whose rows from 4,194,304 on start past byte
     2^31; f32 tower (256, 128, 64), no rounding, unique_cap 49152, batch
     8192:
     20a. (run after phase 3b) K1/K2 at that pool's bench_rows case (49152
       rows of 512 B, ~10% -1) bit for bit and timed as phase 3, with at
       least 2,000 valid rows past byte 2^31; then K2 of fresh values into
       exactly the top 8,192 rows and K1 of them, bit for bit against the
       plain versions (two copies of the pool: ~6.9 GB on the card);
     20b. (20b-20f run after phase 19) 4 train steps + 1 eval batch: K1 5,
       K2 4, K3 0;
     20c. the synchronous block (steps_per_dispatch=8) run as 5b: K1 26,
       K2 25, K3 0; losses within rtol 1e-4 of 20b's over its 4 steps, and
       falling;
     20d. the asynchronous block (MT_BENCH_ASYNC=1) run as 5c: K1 50, K2
       25, K3 0; the first two losses within rtol 1e-4 of 20b's, falling;
     20e. the small variant with f32 pools and tower on the card and on
       the CPU from one carried state, 3 steps: losses rtol 1e-4;
     20f. the per-step path binned at 1 GiB (MT_BENCH_MERGE_MAX_GB=1):
       pools [2^21, 128], [2^21, 128] and [2^18, 128] f32, 3 K1 and 3 K2 a
       step (K1 15, K2 12 over 4 steps + 1 eval), finite losses, an eval
       AUC in [0, 1].
     Phase 20's launches count as the multislot_f32 entries' paths
     "per_step", "block", "block_async" and "binned".

TF32 is off for matrix products and convolutions (torch.backends), so the
card's f32 dense towers run in full f32 like the CPU's. The second-to-last
line is the kernels' JSON (one entry per kernel and path); the last is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

# the multislot bf16 path: pool rows, row width, rows per step
MS_CAP, WIDTH, MS_U = 17 * (1 << 18), 128, 49152


def log(msg):
    print(msg, flush=True)


def kernel_times(fn):
    """A kernel's event times over 20 flushed launches: the mean (`ms`, as
    every other time of the line) and the median, which one slow launch
    does not move."""
    from monolith_tpu_torch.timing import event_times_ms
    times = event_times_ms(fn)
    return {"ms": float(np.mean(times)), "ms_median": float(np.median(times))}


def phase_build():
    from monolith_tpu_torch import build
    results, errors = {}, []

    def run(name, fn):
        try:
            t0 = time.time()
            results[name] = (fn(), time.time() - t0)
        except Exception as e:  # re-raised below, after every build ends
            errors.append(e)

    from monolith_tpu_torch.bench_rounding import BASELINE, BASELINE_SRC
    # the earlier K3 design, on no path: phase 3's timing baseline
    baseline = f"rounding_{BASELINE}"
    jobs = [("host", build.build_host_library)] + [
        (f"lib{k}", lambda k=k: build.build_kernel_library(k))
        for k in build.KERNEL_SOURCES] + [
        (f"lib{baseline}",
         lambda: build.build_kernel_library(baseline, BASELINE_SRC))]
    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for name, (path, secs) in results.items():
        log(f"built {name}: {os.path.relpath(path)} in {secs:.1f} s")
    for k in (*build.KERNEL_SOURCES, baseline):
        log(f"ptxas lib{k}: " + " | ".join(
            ln.strip() for ln in build.build_log(f"lib{k}").splitlines()
            if "registers" in ln or "Compiling" in ln))


def phase_rows(path, floor, case=None):
    """K1/K2 at one path's shapes against their plain versions. `case` is
    (pool, rows, values) on the card; by default bench_rows' case at the
    path's SHAPES."""
    import torch
    from monolith_tpu_torch.bench_rows import SHAPES, bounds_ms, make_case
    from monolith_tpu_torch.ops import scatter as ops
    from monolith_tpu_torch.timing import time_ms
    pool, rows, values = case or make_case(*SHAPES[path])
    (cap, width), dtype, u = pool.shape, pool.dtype, rows.shape[0]
    valid = rows >= 0
    n_valid = int(valid.sum())
    row_bytes = width * pool.element_size()
    tname = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    shape = f"pool [{cap},{width}] {tname}, rows [{u}] ({n_valid} valid)"

    out = ops.gather_rows(pool, rows)
    ref = ops.gather_rows_plain(pool, rows)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16)), \
        f"gather_rows differs from its plain version ({shape})"
    gather_err = float((out.float() - ref.float()).abs().max())

    pool_k, pool_p = pool.clone(), pool.clone()
    ops.scatter_rows(pool_k, rows, values)
    ops.scatter_rows_plain(pool_p, rows, values)
    torch.cuda.synchronize()
    assert torch.equal(pool_k.view(torch.int16), pool_p.view(torch.int16)), \
        f"scatter_rows differs from its plain version ({shape})"
    scatter_err = float((pool_k.float() - pool_p.float()).abs().max())
    del pool_p, ref, out

    geometry = ops.kernel_geometry(u, row_bytes)
    tile_rows, smem = ops.tile_geometry(row_bytes)
    assert (geometry["warps"], geometry["stages"], geometry["tile_rows"],
            geometry["smem_bytes"]) == (ops.WARPS, ops.STAGES, tile_rows,
                                        smem), geometry
    grid = ops.grid_size(u, tile_rows, geometry["blocks_per_sm"],
                         geometry["sms"])
    assert geometry["gather_grid"] == geometry["scatter_grid"] == grid, \
        (geometry, grid)

    safe = rows.clamp(min=0).long()
    vrows, vvals = rows[valid].long(), values[valid]
    # K1: rows read + valid pool rows read + every output row written;
    # K2: rows read + valid value rows read + valid pool rows written
    bound1, bound2 = bounds_ms(u, n_valid, row_bytes)
    k1 = {"name": "gather_rows", "path": path, "route": "cuda",
          "source": "monolith_tpu_torch/csrc/rows.cu",
          "replaces": "monolith_tpu/ops/scatter.py:143", "shape": shape,
          "max_abs_err": gather_err,
          **kernel_times(lambda: ops.gather_rows(pool, rows)),
          "plain_ms": time_ms(lambda: ops.gather_rows_plain(pool, rows)),
          "bound_ms": bound1, "bound_by": "bytes",
          "library_ms": time_ms(lambda: torch.index_select(pool, 0, safe))}
    k2 = {"name": "scatter_rows", "path": path, "route": "cuda",
          "source": "monolith_tpu_torch/csrc/rows.cu",
          "replaces": "monolith_tpu/ops/scatter.py:177", "shape": shape,
          "max_abs_err": scatter_err,
          **kernel_times(lambda: ops.scatter_rows(pool_k, rows, values)),
          "plain_ms": time_ms(lambda: ops.scatter_rows_plain(pool_k, rows,
                                                             values)),
          "bound_ms": bound2, "bound_by": "bytes",
          "library_ms": time_ms(lambda: pool_k.index_copy_(0, vrows, vvals))}
    for k in (k1, k2):
        k["event_floor_ms"] = floor
        log(f"{k['name']} [{path}]: bit-exact; {k['ms']:.4f} ms by events "
            f"(median {k['ms_median']:.4f}, floor {floor:.4f}; plain {k['plain_ms']:.4f}, library "
            f"{k['library_ms']:.4f}, bound {k['bound_ms']:.4f}); {shape}; "
            f"grid {grid} x {ops.WARPS} warps, {tile_rows} rows a tile, "
            f"{smem} B of shared memory")
    return [k1, k2]


# the lengths K1/K2 meet outside a train step (phase 10), by path: (rows a
# call, valid rows of a -1 tailed call or None for ~1% of -1 inside)
OUT_OF_STEP_SHAPES = {
    "deepfm_f32": [(1 << 15, 21_300), (1 << 17, 98_304), (1 << 18, 140_685),
                   (1 << 19, 393_216), (1 << 20, 608_846),
                   (294_838, None), (504_203, None)],
    "multislot_bf16": [(540_468, None)]}


def phase_rows_out_of_step(path):
    """3b: K1/K2 against their plain versions, bit for bit, at the lengths
    the sync rounds, the delta, the exports, expiry's zeroing and the
    tiered spill give them on this path's pool. At a power-of-two length
    with a -1 tail K2 also writes zero rows, as zero_rows does."""
    import torch
    from monolith_tpu_torch.bench_rows import SHAPES
    from monolith_tpu_torch.ops import scatter as ops
    cap, width, dtype, _ = SHAPES[path]
    g = torch.Generator(device="cuda").manual_seed(2)
    pool = torch.randn((cap, width), generator=g, device="cuda").to(dtype)
    done = []
    for n, live in OUT_OF_STEP_SHAPES[path]:
        rows = torch.randperm(cap, generator=g, device="cuda")[:n].int()
        if live is None:
            rows[torch.rand(n, generator=g, device="cuda") < 0.01] = -1
        else:
            rows[live:] = -1
        values = torch.randn((n, width), generator=g,
                             device="cuda").to(dtype)
        shape = f"{path}, rows [{n}] ({int((rows >= 0).sum())} valid)"
        out = ops.gather_rows(pool, rows)
        assert torch.equal(out.view(torch.int16),
                           ops.gather_rows_plain(pool, rows).view(
                               torch.int16)), \
            f"gather_rows differs from its plain version ({shape})"
        del out
        pool_k, pool_p = pool.clone(), pool.clone()
        ops.scatter_rows(pool_k, rows, values)
        ops.scatter_rows_plain(pool_p, rows, values)
        assert torch.equal(pool_k.view(torch.int16),
                           pool_p.view(torch.int16)), \
            f"scatter_rows differs from its plain version ({shape})"
        if live is not None:
            zeros = torch.zeros_like(values)
            ops.scatter_rows(pool_k, rows, zeros)
            ops.scatter_rows_plain(pool_p, rows, zeros)
            assert torch.equal(pool_k.view(torch.int16),
                               pool_p.view(torch.int16)), \
                f"scatter_rows of zero rows differs ({shape})"
        del pool_k, pool_p
        done.append(shape.split(", ", 1)[1])
    log(f"gather_rows, scatter_rows [{path}] at the lengths outside a train "
        f"step: bit-exact at {'; '.join(done)}")


def phase_rounding(path, floor, x=None, ragged=()):
    """K3 against its plain version: at the multislot path's shape, or on
    `x` (f32 on the card); each shape of `ragged` is held bit for bit too
    (timed in phase 9 only). The earlier one-group design
    (csrc/baselines/rounding_one_group.cu, on no path) is held against the
    same plain version at the same shapes and timed in turns with the
    kernel (events here, the profiler in phase 9); beside them an empty
    kernel on the same grid."""
    import torch
    from monolith_tpu_torch import bench_rounding
    from monolith_tpu_torch.ops import rounding
    from monolith_tpu_torch.timing import time_ms
    g = torch.Generator(device="cuda").manual_seed(1)
    if x is None:
        x = torch.randn((MS_U, WIDTH), generator=g, device="cuda")
    seed = 0x0123456789ABCDEF
    one_group = {bench_rounding.BASELINE: bench_rounding.baseline_library()}
    for shape in ragged:
        small = torch.randn(shape, generator=g, device="cuda")
        assert torch.equal(
            rounding.stochastic_round_bf16(small, seed).view(torch.int16),
            rounding.stochastic_round_bf16_plain(small, seed).view(
                torch.int16)), f"stochastic_round_bf16 differs at {shape}"
        bench_rounding.check_builds(one_group, small, seed)
    out = rounding.stochastic_round_bf16(x, seed)
    ref = rounding.stochastic_round_bf16_plain(x, seed)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16)), \
        "stochastic_round_bf16 differs from its plain version"
    bench_rounding.check_builds(one_group, x, seed)
    mean_gap = float((out.float().mean(dtype=torch.float64)
                      - x.mean(dtype=torch.float64)).abs())
    assert mean_gap < 2 ** -10, mean_gap
    n = x.numel()
    bytes_ms, ops_ms = bench_rounding.bounds_ms(n)
    shape = "x [" + ",".join(map(str, x.shape)) + "] f32 -> bf16" + "".join(
        f"; bit-exact at [{','.join(map(str, r))}] too" for r in ragged)
    turns = bench_rounding.time_in_turns(
        {**one_group, "here": rounding.kernel_library()}, x, seed=seed)
    k3 = {"name": "stochastic_round_bf16", "path": path, "route": "cuda",
          "source": "monolith_tpu_torch/csrc/rounding.cu",
          "replaces": "monolith_tpu/ops/rounding.py:33",
          "shape": shape, "geometry": rounding.kernel_geometry(n),
          "ragged_shapes": [list(r) for r in ragged],
          "max_abs_err": float((out.float() - ref.float()).abs().max()),
          "mean_gap": mean_gap,
          **kernel_times(lambda: rounding.stochastic_round_bf16(x, seed)),
          "event_floor_ms": floor,
          "in_turns_ms": turns,
          "empty_grid_ms": time_ms(lambda: bench_rounding.empty_launch(n)),
          "plain_ms": time_ms(
              lambda: rounding.stochastic_round_bf16_plain(x, seed)),
          "bound_ms": max(bytes_ms, ops_ms),
          "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
          # round-to-nearest over the same bytes: no PyTorch call rounds
          # stochastically, so this is a yardstick, not the same function
          "library_ms": time_ms(lambda: x.to(torch.bfloat16)),
          "library_call": "x.to(torch.bfloat16) (round to nearest)"}
    log(f"stochastic_round_bf16 [{path}]: bit-exact (and the one-group "
        f"design too), mean gap {mean_gap:.3e}; {k3['ms']:.4f} ms by events "
        f"(median {k3['ms_median']:.4f}, floor {floor:.4f}; in turns with "
        f"the one-group design {_turns_text(turns)}; an empty kernel on "
        f"the same grid {k3['empty_grid_ms']:.4f}; plain "
        f"{k3['plain_ms']:.4f}, x.to(bf16) "
        f"{k3['library_ms']:.4f}, bound {k3['bound_ms']:.4f} by "
        f"{k3['bound_by']}; ops bound {ops_ms:.4f}); {shape}; grid "
        f"{k3['geometry']['grid']} x {k3['geometry']['threads']} threads, "
        f"{k3['geometry']['octets']} octets a thread a trip")
    return [k3]


def _turns_text(turns):
    """'here a, b; one_group c, d' of bench_rounding.time_in_turns."""
    return "; ".join(f"{name} " + ", ".join(f"{t:.5f}" for t in ts)
                     for name, ts in turns.items())


def rounding_durations(k, x):
    """Phase 9's readings of a K3 entry on its input x: the kernel and the
    one-group design in turns by the profiler, after the protocol's flush
    (an L2 full of dirty lines) and after one that reads (clean lines),
    beside an empty kernel on the same grid and x.to(bf16) read the same
    ways; the ragged shapes the same. Prints the comparison line."""
    import torch
    from monolith_tpu_torch import bench_rounding
    from monolith_tpu_torch.ops import rounding
    libs = {bench_rounding.BASELINE: bench_rounding.baseline_library(),
            "here": rounding.kernel_library()}

    def readings(x):
        return {flush: bench_rounding.profiler_readings(libs, x, flush)
                for flush in bench_rounding.FLUSHES}

    def mean(ts):
        return float(np.mean(ts))

    k["profiler_in_turns_ms"] = r = readings(x)
    k["one_group_ms_profiler"] = before = mean(
        r["write"][bench_rounding.BASELINE])
    k["kernel_ms_profiler_in_turns"] = now = mean(r["write"]["here"])
    line = (f"K3 redesigned [{k['path']}] {k['shape'].split(';')[0]}: "
            f"{now:.7f} ms by the profiler against the one-group design's "
            f"{before:.7f} (in turns: "
            f"{_turns_text({n: r['write'][n] for n in libs})}); bound "
            f"{k['bound_ms']:.7f}: {k['bound_ms'] / now:.1%} of it now, "
            f"{k['bound_ms'] / before:.1%} before; an empty kernel on the "
            f"same grid "
            f"{r['write']['empty_grid']:.7f}; x.to(bf16) "
            f"{r['write']['to_bf16']:.7f}. After a flush that reads: "
            f"{_turns_text({n: r['read'][n] for n in libs})}; empty grid "
            f"{r['read']['empty_grid']:.7f}; x.to(bf16) "
            f"{r['read']['to_bf16']:.7f}")
    k["ragged"] = []
    g = torch.Generator(device="cuda").manual_seed(4)
    for shape in k.get("ragged_shapes", []):
        rr = readings(torch.randn(shape, generator=g, device="cuda"))
        k["ragged"].append({"shape": shape, "profiler_in_turns_ms": rr})
        line += (f". Ragged {shape}: "
                 f"{_turns_text({n: rr['write'][n] for n in libs})}; empty "
                 f"grid {rr['write']['empty_grid']:.7f}")
    log(line)


def phase_kernel_durations(kernels, cases, rounding_cases=None):
    """Each kernel's own duration, by kernel name, from a torch.profiler
    window (CPU + CUDA) over 20 flushed launches at the shapes of phase 3
    (and of `cases`, {path: (pool, rows, values)}, and K3's of
    `rounding_cases`, {path: x}, for the paths phase 3 does not make),
    written into its entry as `kernel_ms_profiler` (None where the
    profiler saw no device time). It runs after every timed phase, so that
    none of them runs in a process that has had the profiler on."""
    import torch
    from monolith_tpu_torch.bench_rows import SHAPES, make_case
    from monolith_tpu_torch.ops import rounding
    from monolith_tpu_torch.ops import scatter as ops
    from monolith_tpu_torch.timing import profiler_ms
    calls = {}
    for path in [*SHAPES, *cases]:
        pool, rows, values = cases.get(path) or make_case(*SHAPES[path])
        calls["gather_rows", path] = (
            lambda pool=pool, rows=rows: ops.gather_rows(pool, rows))
        calls["scatter_rows", path] = (
            lambda pool=pool, rows=rows, values=values:
            ops.scatter_rows(pool, rows, values))
    x = torch.randn((MS_U, WIDTH), device="cuda")
    calls["stochastic_round_bf16", "multislot_bf16"] = (
        lambda: rounding.stochastic_round_bf16(x, 1))
    for path, xr in (rounding_cases or {}).items():
        calls["stochastic_round_bf16", path] = (
            lambda xr=xr: rounding.stochastic_round_bf16(xr, 1))
    for k in kernels:
        ms = profiler_ms(calls[k["name"], k["path"]], k["name"] + "_kernel")
        k["kernel_ms_profiler"] = ms
        log(f"{k['name']} [{k['path']}]: "
            + ("the profiler saw no device time" if ms is None else
               f"{ms:.4f} ms by the profiler's kernel duration ({k['ms']:.4f} "
               f"by events, floor {k['event_floor_ms']:.4f}, bound "
               f"{k['bound_ms']:.4f})"))
    rounding_x = {"multislot_bf16": x, **(rounding_cases or {})}
    for k in kernels:
        if k["name"] == "stochastic_round_bf16":
            rounding_durations(k, rounding_x[k["path"]])


def drive_path(name, trainer, batches, steps, evals, expect):
    """`steps` train steps and `evals` eval batches through the Trainer's
    entry points, with every kernel's launch count set to 0 just before and
    read just after; checks the counts against `expect` and returns them."""
    import torch
    from monolith_tpu_torch import ops
    batch = len(batches[0][1]["label"])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    losses, times, uniques = [], [], []
    for fb, b in batches[:steps]:
        t0 = time.perf_counter()
        out = trainer.train_step(fb, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(out["loss"])
        uniques.append(sum(out["stats"]["unique"].values()))
        assert out["preds"].shape == (batch,)
        assert not any(out["stats"]["overflow"].values()), out["stats"]
    ev = trainer.evaluate(iter(batches[steps:]), max_steps=evals)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    losses = torch.stack(losses).cpu().numpy()
    assert np.isfinite(losses).all(), f"non-finite losses {losses}"
    assert np.isfinite(ev["loss"]) and 0.0 <= ev["auc"] <= 1.0, ev
    assert launches == expect, (launches, expect)
    log(f"{name} path: losses {np.round(losses, 5).tolist()}; eval {ev}; "
        f"ms/step {1e3 * np.mean(times[2:]):.3f} (steps 3-{steps}, host "
        f"clock with synchronize; first step {1e3 * times[0]:.1f} ms); "
        f"uniques/step {int(np.mean(uniques))}; launches {launches}")
    return launches, losses


PATH_STEPS, PATH_EVALS = 4, 1   # the per-step path phases
BLOCK_K, BLOCKS = 8, 3          # the block path phases


def phase_deepfm_path():
    """Full-width DeepFM: 4 train steps + 1 eval batch."""
    from monolith_tpu_torch.profile_step import CONFIGS
    steps, evals = PATH_STEPS, PATH_EVALS
    trainer, data = CONFIGS["deepfm"]()
    batches = [data.batch() for _ in range(steps + evals)]
    return drive_path("deepfm_f32", trainer, batches, steps, evals,
                      {"gather_rows": steps + evals, "scatter_rows": steps,
                       "stochastic_round_bf16": 0})  # (launches, losses)


def phase_multislot_path():
    """Full-width multislot bf16 (bench.py:224-242 with
    MT_BENCH_DTYPE=bf16): 4 train steps + 1 eval batch."""
    import torch
    from monolith_tpu_torch.profile_step import CONFIGS
    steps, evals = PATH_STEPS, PATH_EVALS
    trainer, data = CONFIGS["multislot_bf16"]()
    pool = trainer.table_states["table_all"]["data"]
    assert pool.dtype == torch.bfloat16 and tuple(pool.shape) == \
        (MS_CAP, WIDTH), (pool.dtype, pool.shape)
    batches = [data.batch() for _ in range(steps + evals)]
    launches, losses = drive_path(
        "multislot_bf16", trainer, batches, steps, evals,
        {"gather_rows": steps + evals, "scatter_rows": steps,
         "stochastic_round_bf16": steps})
    assert trainer.table_states["table_all"]["data"].dtype == torch.bfloat16
    return launches, losses


def drive_block_path(name, trainer, data, expect, per_step_losses, same,
                     rtol, falling):
    """One train_step, then BLOCKS blocks of BLOCK_K through `train` (each
    block staged while the one before it dispatches), then 1 eval batch,
    with every kernel's launch count set to 0 just before and read just
    after. Every train_step_block runs with PyTorch's synchronisation
    check set to raise, so a host-device synchronisation inside a block
    fails the phase. The losses must be finite, agree over their first
    `same` steps with `per_step_losses` (the per-step path's on the same
    stream, from a trainer of the same seed) to `rtol`, and fall
    (`falling`: the mean of the last block under the mean of the first 8
    steps) or, on a stream whose ids hardly repeat within 25 steps, stay
    within 0.01 of where they began. The blocks run under a recording of
    the program's spans, whose host prepare, batch copy and upload start
    are logged. Then, outside the counted run: a staged block dispatched
    out of turn must raise; the per-step path's time in the same trainer."""
    import torch
    from monolith_tpu_torch import ops
    from monolith_tpu_torch.utils import tracing
    K, n = BLOCK_K, BLOCK_K * BLOCKS
    batches = [data.batch() for _ in range(1 + n + 1)]
    batch = len(batches[0][1]["label"])
    block = trainer.train_step_block

    def checked_block(pairs, ts=None, staged=None):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return block(pairs, ts=ts, staged=staged)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    trainer.train_step_block = checked_block
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    first = trainer.train_step(*batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    with tracing.recording() as rec:
        trainer.train(iter(batches[1:1 + n]), steps=n,
                      hooks=(lambda _, out: outs.append(out),))
    torch.cuda.synchronize()
    block_ms = (time.perf_counter() - t0) / n * 1e3
    spans = rec.totals()
    prep_ms, copy_ms, upload_ms = (
        spans[k].seconds / spans[k].count * 1e3
        for k in ("stage.prepare", "stage.copy_batch", "stage.upload"))
    ev = trainer.evaluate(iter(batches[1 + n:]), max_steps=1)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert launches == expect, (launches, expect)
    assert trainer.step == 1 + n
    for out in outs:
        assert out["loss"].shape == (K,) and out["preds"].shape == (K, batch)
        assert len(out["stats"]) == K
        assert not any(any(st["overflow"].values()) for st in out["stats"])
    losses = torch.cat([first["loss"][None]] + [o["loss"] for o in outs]
                       ).cpu().numpy()
    assert np.isfinite(losses).all(), f"non-finite losses {losses}"
    np.testing.assert_allclose(losses[:same], per_step_losses[:same],
                               rtol=rtol)
    if falling:
        assert losses[-K:].mean() < losses[:K].mean(), \
            f"loss not falling {losses}"
    else:
        assert np.abs(losses - losses[0]).max() < 0.01, \
            f"loss drifting {losses}"
    assert np.isfinite(ev["loss"]) and 0.0 <= ev["auc"] <= 1.0, ev

    # a staged block is only good for the very next dispatch
    more = [data.batch() for _ in range(2 * K + 1)]
    staged = trainer.stage_block(more[:K])
    trainer.train_step(*more[2 * K])
    try:
        trainer.train_step_block(more[:K], staged=staged)
    except ValueError as e:
        assert "not the next dispatch" in str(e), e
    else:
        raise AssertionError("a staged block dispatched out of turn ran")

    # the per-step path in the same trainer, no synchronisation between
    # steps either
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fb, b in more[K:2 * K]:
        trainer.train_step(fb, b)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / K * 1e3
    log(f"{name} block path: losses {np.round(losses, 5).tolist()}; eval "
        f"{ev}; ms/step {block_ms:.3f} over {BLOCKS} blocks of {K} (host "
        f"clock, one synchronize at the end); per-step path in the same "
        f"trainer {step_ms:.3f} ms/step ({K} steps, one synchronize at the "
        f"end); spans of the blocks: host prepare {prep_ms:.3f} ms/step, "
        f"batch copy {copy_ms:.3f} ms/step, upload start {upload_ms:.3f} "
        f"ms/block; launches {launches}")
    trainer.train_step_block = block
    return {"launches": launches, "trainer": trainer, "data": data,
            "seen": more[2 * K - 1]}


def phase_deepfm_block_path(per_step_losses):
    """Full-width DeepFM (bench.py:178-185), steps_per_dispatch=8. Its
    stream (10^6 users, 2 x 10^5 items) hardly repeats an id within 25
    steps of 8192, so the loss stays at its start (0.696) and is held
    against the per-step path's instead of being asked to fall."""
    from monolith_tpu_torch.profile_step import CONFIGS
    trainer, data = CONFIGS["deepfm"](steps_per_dispatch=BLOCK_K,
                                      record_touch=True)
    n = BLOCK_K * BLOCKS
    return drive_block_path("deepfm_f32", trainer, data,
                            {"gather_rows": 1 + n + 1, "scatter_rows": 1 + n,
                             "stochastic_round_bf16": 0},
                            per_step_losses, same=PATH_STEPS, rtol=1e-4,
                            falling=False)


def phase_multislot_async_block_path(per_step_losses):
    """Full-width multislot bf16 (bench.py:224-242 with MT_BENCH_DTYPE=bf16
    and MT_BENCH_ASYNC=1): the 1-step-stale block. Two K1 launches a step
    of a block (stale, then fresh); one K2 and one K3 a step: the first
    step of a block has no pending write-back and launches none, and the
    last step's lands at the end of its block. The first two steps (the
    single step and the first of a block, which has nothing pending) see
    no staleness and must give the per-step path's losses (rtol 1e-3: bf16
    pools and tower)."""
    from monolith_tpu_torch.profile_step import CONFIGS
    trainer, data = CONFIGS["multislot_bf16"](steps_per_dispatch=BLOCK_K,
                                              async_optimize=True)
    assert trainer.config.engine.async_optimize
    n = BLOCK_K * BLOCKS
    return drive_block_path("multislot_bf16 asynchronous", trainer, data,
                            {"gather_rows": 1 + 2 * n + 1,
                             "scatter_rows": 1 + n,
                             "stochastic_round_bf16": 1 + n},
                            per_step_losses, same=2, rtol=1e-3, falling=True)


def phase_block_card_vs_cpu():
    """One carried state, one block of 4 on the card and on the CPU,
    init_scale=0.0 (the two devices' generators draw different inits),
    clip_norm 0.05, the DeepFM's vector segment under DC(lambda_=50):
    synchronous and asynchronous, on batches that repeat their ids (so
    that the asynchronous forward is stale). The pooling backward's
    atomics forbid bit-exactness on the card: losses rtol 1e-4, live pool
    rows rtol 1e-4 / atol 1e-5. Then the small multislot bf16 variant
    (stochastic rounding, bf16 tower), asynchronous: losses rtol 1e-3."""
    import dataclasses

    from monolith_tpu_torch import convert
    from monolith_tpu_torch.data.synthetic import SyntheticMultiSlot
    from monolith_tpu_torch.embedding import optimizers
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

    class DCDeepFM(DeepFMTask):
        def tables(self):
            t = super().tables()[0]
            vec = t.segments[1]
            vec = dataclasses.replace(vec, optimizer=optimizers.DC(
                learning_rate=vec.optimizer.learning_rate, lambda_=50.0,
                base=vec.optimizer))
            return [dataclasses.replace(t, segments=(t.segments[0], vec))]

    def deepfm(device, stale):
        return Trainer(DCDeepFM(capacity_per_shard=4096, hidden=(32, 16),
                                init_scale=0.0),
                       TrainerConfig(engine=EngineConfig(
                           unique_cap=512, new_cap=512, async_optimize=stale),
                           clip_norm=0.05, log_every=0), device=device)

    def multislot(device, stale):
        return small_multislot(device, async_optimize=stale, clip_norm=0.05,
                               init_scale=0.0)

    rng = np.random.default_rng(11)
    ids = np.arange(200)
    pairs = [({"user_id": rng.choice(ids, (64, 1)).astype(np.int64),
               "item_id": rng.choice(ids, (64, 1)).astype(np.int64),
               "hist_items": rng.choice(ids, (64, 10)).astype(np.int64)},
              {"label": rng.integers(0, 2, 64).astype(np.float32)})
             for _ in range(5)]
    ms_data = SyntheticMultiSlot(num_slots=10, vocab_per_slot=300,
                                 history_length=6, batch_size=256, seed=11)
    ms_pairs = [ms_data.batch() for _ in range(5)]
    for name, make, batches, stale, rtol, pools in (
            ("deepfm f32 + DC, synchronous", deepfm, pairs, False, 1e-4, True),
            ("deepfm f32 + DC, asynchronous", deepfm, pairs, True, 1e-4, True),
            ("multislot bf16, asynchronous", multislot, ms_pairs, True, 1e-3,
             False)):
        cpu = make("cpu", stale)
        cpu.train_step(*batches[0], ts=500)
        card = make("cuda", stale)
        convert.load_state(card, convert.export_state(cpu))
        lc = cpu.train_step_block(batches[1:], ts=501)["loss"].numpy()
        lg = card.train_step_block(batches[1:], ts=501)["loss"].cpu().numpy()
        gap = float(np.max(np.abs(lg / lc - 1)))
        log(f"block card vs cpu, {name}: losses {lg.tolist()} vs "
            f"{lc.tolist()}; worst relative gap {gap:.3e}")
        np.testing.assert_allclose(lg, lc, rtol=rtol)
        if pools:
            sc, sg = convert.export_state(cpu), convert.export_state(card)
            for t in sc["tables"]:
                live = np.sort(sc["stores"][t][1])
                np.testing.assert_allclose(sg["tables"][t][0][live],
                                           sc["tables"][t][0][live],
                                           rtol=1e-4, atol=1e-5)
        assert card.step == cpu.step == 5


def phase_card_vs_cpu():
    """DeepFM f32: one carried state, 3 steps on the card and on the CPU:
    losses agree to rtol 1e-4 (the card's index-add backward uses atomics
    in a varying order, and its reductions sum in another order than the
    CPU's)."""
    from monolith_tpu_torch import convert
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

    def make(device):
        return Trainer(DeepFMTask(capacity_per_shard=4096, hidden=(32, 16),
                                  init_scale=0.0),
                       TrainerConfig(engine=EngineConfig(unique_cap=512,
                                                         new_cap=512),
                                     log_every=0), device=device)

    data = SyntheticCTR(num_users=400, num_items=300, batch_size=64, seed=11)
    batches = [data.batch() for _ in range(6)]
    cpu = make("cpu")
    for i in range(3):
        cpu.train_step(*batches[i], ts=500 + i)
    card = make("cuda")
    convert.load_state(card, convert.export_state(cpu))
    lc, lg = [], []
    for i in range(3, 6):
        lc.append(cpu.train_step(*batches[i], ts=500 + i)["loss"].item())
        lg.append(card.train_step(*batches[i], ts=500 + i)["loss"].item())
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    log(f"card vs cpu losses: {lg} vs {lc}")


def small_multislot(device, async_optimize=False, clip_norm=0.0, **kw):
    """The bench's bf16 variant at the JAX package's test size
    (tests/test_models.py); `kw` goes to the task."""
    import torch
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.multislot import MultiSlotTask
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig
    task = MultiSlotTask(**{**dict(
        num_tables=4, num_slots=10, embedding_dim=8, capacity_per_shard=8192,
        history_length=6, hidden=(32,), merge=True,
        table_dtype=torch.bfloat16, stochastic_rounding=True,
        dense_dtype=torch.bfloat16), **kw})
    return Trainer(task, TrainerConfig(engine=EngineConfig(
        unique_cap=2048, new_cap=2048, async_optimize=async_optimize),
        clip_norm=clip_norm, log_every=0), device=device)


def phase_multislot_card_vs_cpu(name="bf16", rtol=1e-3, **task):
    """The small bf16 variant (bf16 pools, stochastic rounding, bf16
    tower): one carried state, 3 steps on the card and on the CPU, with
    init_scale=0.0 (new rows draw their init from the device's generator,
    whose numbers differ between card and CPU). K3 draws the plain
    version's bits, but the pooling backward's atomics and the card's bf16
    matrix products change bits, which can flip a rounding: losses agree
    to rtol 1e-3. `task` overrides the variant's task settings (20e: the
    f32 pool and tower, rtol 1e-4)."""
    from monolith_tpu_torch import convert
    from monolith_tpu_torch.data.synthetic import SyntheticMultiSlot
    data = SyntheticMultiSlot(num_slots=10, vocab_per_slot=300,
                              history_length=6, batch_size=256, seed=11)
    batches = [data.batch() for _ in range(6)]
    cpu = small_multislot("cpu", init_scale=0.0, **task)
    for i in range(3):
        cpu.train_step(*batches[i], ts=500 + i)
    card = small_multislot("cuda", init_scale=0.0, **task)
    convert.load_state(card, convert.export_state(cpu))
    lc, lg = [], []
    for i in range(3, 6):
        lc.append(cpu.train_step(*batches[i], ts=500 + i)["loss"].item())
        lg.append(card.train_step(*batches[i], ts=500 + i)["loss"].item())
    gap = float(np.max(np.abs(np.array(lg) / np.array(lc) - 1)))
    log(f"multislot {name} card vs cpu losses: {lg} vs {lc}; worst relative "
        f"gap {gap:.3e}")
    np.testing.assert_allclose(lg, lc, rtol=rtol)


def phase_multislot_trains():
    """The small bf16 bench variant trained on the card for 41 steps
    reaches the JAX package's AUC bar (tests/test_models.py)."""
    import torch
    from monolith_tpu_torch.data.synthetic import SyntheticMultiSlot
    tr = small_multislot("cuda")
    data = SyntheticMultiSlot(num_slots=10, vocab_per_slot=300,
                              history_length=6, batch_size=256, seed=1)
    res = tr.train(iter(data), steps=41)
    log(f"multislot bf16 small, 41 steps on the card: {res}")
    assert np.isfinite(res["loss"]) and res["auc"] > 0.515, res
    assert tr.table_states["table_all"]["data"].dtype == torch.bfloat16


def phase_northstar():
    from monolith_tpu_torch.demo import NORTHSTAR_BAND, northstar
    t0 = time.time()
    r = northstar(device="cuda")
    lo, hi = NORTHSTAR_BAND
    log(f"northstar: {r} in {time.time() - t0:.1f} s")
    assert lo <= r["eval_auc"] <= hi, (r["eval_auc"], NORTHSTAR_BAND)


# ----------------------------------------------------------------------
# phase 10: checkpoint, export, serving, streaming push, delta, hot swap
# ----------------------------------------------------------------------

def _tree_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def _stores_equal(a, b):
    for t in a.engine.stores:
        sa, sb = a.engine.stores[t].save(), b.engine.stores[t].save()
        oa, ob = np.argsort(sa[0]), np.argsort(sb[0])
        for x, y in zip(sa, sb):
            np.testing.assert_array_equal(x[oa], y[ob])


def phase_checkpoint(trainer, seen, work):
    """10a: save -> a fresh trainer -> restore, bit for bit; then one
    train_step of each on a batch whose ids both know."""
    import torch
    from monolith_tpu_torch.profile_step import CONFIGS
    from monolith_tpu_torch.training import checkpoint
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = checkpoint.save(trainer, work)
    save_s = time.perf_counter() - t0
    fresh, _ = CONFIGS["deepfm"](steps_per_dispatch=BLOCK_K,
                                 record_touch=True)
    t0 = time.perf_counter()
    step = checkpoint.restore(fresh, work)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    assert step == fresh.step == trainer.step
    for t, st in trainer.table_states.items():
        assert torch.equal(st["data"], fresh.table_states[t]["data"]), t
    _stores_equal(trainer, fresh)
    theirs = dict(fresh.module.named_parameters())
    for name, p in trainer.module.named_parameters():
        assert torch.equal(p, theirs[name]), name
        assert torch.equal(trainer.opt_state[name], fresh.opt_state[name])
    ts = int(time.time())
    la = trainer.train_step(*seen, ts=ts)
    lb = fresh.train_step(*seen, ts=ts)
    assert not any(la["stats"]["new"].values()), la["stats"]
    np.testing.assert_allclose(lb["loss"].item(), la["loss"].item(),
                               rtol=1e-6)
    rows = {t: s.size() for t, s in trainer.engine.stores.items()}
    log(f"checkpoint: save {save_s:.3f} s, restore {restore_s:.3f} s (into a "
        f"fresh trainer; live prefix uploaded, rows above it made on the "
        f"card), {_tree_bytes(path)} bytes on disk, live rows {rows}, step "
        f"{step}; restored state equal bit for bit; next loss "
        f"{lb['loss'].item():.6f} vs {la['loss'].item():.6f}")
    return fresh


def phase_export_serve(name, trainer, data, work, unique_cap, predicts,
                       rtol, **model_kw):
    """10b: export_model -> ServingModel on the card -> `predicts`
    predicts at the stream's batch, each held against the trainer's eval
    predictions on the same batch."""
    import torch
    from monolith_tpu_torch import ops
    from monolith_tpu_torch.serving import ServingModel, export_model
    tables = len(trainer.engine.tables)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    path = export_model(trainer, work)
    export_s = time.perf_counter() - t0
    # the export gathers each table's live rows once
    assert ops.launch_counts()["gather_rows"] == tables, ops.launch_counts()
    t0 = time.perf_counter()
    model = ServingModel(trainer.task, path, unique_cap=unique_cap,
                         **model_kw)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    assert all(p.is_cuda and p.dtype == torch.float32
               for p in model.pools.values())
    assert model.step == trainer.step
    for t, store in trainer.engine.stores.items():
        _serving_rows_equal_trainer(model, trainer, t, store.save()[0])
    model.predict(*data.batch())            # warm-up
    total, parts = [], []
    for _ in range(predicts):
        fb, b = data.batch()
        batch = len(b["label"])
        split = {}
        t0 = time.perf_counter()
        preds = model.predict(fb, b, timing=split)
        total.append((time.perf_counter() - t0) * 1e3)
        parts.append([split[k] for k in ("prepare_ms", "device_ms",
                                         "readback_ms")])
        assert preds.shape == (batch,) and np.isfinite(preds).all()
        np.testing.assert_allclose(
            preds, trainer.predict(fb, b).cpu().numpy(), rtol=rtol,
            atol=1e-5)
    launches = ops.launch_counts()
    # serving launches no kernel: the export's gathers and one K1 for each
    # of the trainer's eval predictions
    assert launches == {"gather_rows": tables + predicts, "scatter_rows": 0,
                        "stochastic_round_bf16": 0}, launches
    prep, dev, read = np.median(np.array(parts), axis=0)
    pool_bytes = sum(p.numel() * p.element_size()
                     for p in model.pools.values())
    log(f"{name} serving: export {export_s:.3f} s ({_tree_bytes(path)} "
        f"bytes), load {load_s:.3f} s, rows {model.table_sizes()}, pools "
        f"{pool_bytes} bytes on the card; every exported row equals the "
        f"trainer's; {predicts} predicts at batch "
        f"{batch} equal the trainer's eval predictions (rtol {rtol}); "
        f"ms/predict {np.median(total):.3f} (median; host clock, predict "
        f"returns numpy); split: host prepare {prep:.3f}, device {dev:.3f} "
        f"(upload + forward, waited for), readback {read:.3f}; launches "
        f"{launches}")
    return model, launches


class PushTo:
    """The stand-in for a parameter-sync client: a push lands in one
    ServingModel's apply_delta, which is all a serving agent does with it."""

    def __init__(self, model):
        self.model, self.pushes = model, []

    def push(self, table, fids, values):
        self.pushes.append((table, fids))
        return self.model.apply_delta(table, fids, values)


def _trainer_rows_plain(trainer, table, fids):
    """The trainer's embedding rows of `fids` [n, dim] f32 on the card, read
    by K1's plain version, so that no kernel computes what a kernel's result
    is held against."""
    import torch
    from monolith_tpu_torch.ops import scatter as ops
    rows = trainer.engine.stores[table].lookup(fids)
    assert (rows >= 0).all()
    packed = ops.gather_rows_plain(
        trainer.table_states[table]["data"],
        torch.from_numpy(np.ascontiguousarray(rows, np.int32)).cuda())
    return packed[:, :trainer.engine.tables[table].dim].float()


def _serving_rows_equal_trainer(model, trainer, table, fids):
    np.testing.assert_array_equal(
        model.lookup_rows(table, fids),
        _trainer_rows_plain(trainer, table, fids).cpu().numpy())


def phase_streaming(trainer, data, model):
    """10c: 16 streaming steps, a sync round every 8, pushes landing in
    the serving model."""
    import torch
    from monolith_tpu_torch import ops
    from monolith_tpu_torch.training.streaming import (StreamingConfig,
                                                       StreamingTrainer)
    steps, every = 16, 8
    probe = data.batch()
    before = model.predict(*probe)
    sync = PushTo(model)
    # the first round drains every id touched since the trainer's first
    # step (~10^6): give the round room for all of them
    st = StreamingTrainer(trainer, sync, StreamingConfig(
        sync_interval_steps=every, max_push_rows=1 << 22))
    batches = [data.batch() for _ in range(steps)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = st.run(iter(batches), max_steps=steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    # one K1 and one K2 a train step; one K1 more for every non-empty
    # (table, round) gather, each of which ended in one push
    assert res["steps"] == steps and len(sync.pushes) >= steps // every
    assert launches == {"gather_rows": steps + len(sync.pushes),
                        "scatter_rows": steps,
                        "stochastic_round_bf16": 0}, (launches,
                                                      len(sync.pushes))
    assert res["pushed_rows"] == sum(len(f) for _, f in sync.pushes) > 0
    pushed = np.unique(np.concatenate([f for _, f in sync.pushes]))
    _serving_rows_equal_trainer(model, trainer, "sparse", pushed)
    after = model.predict(*probe)
    assert not np.allclose(before, after), "the push changed no prediction"
    # sync rounds alone, timed: touch ids, then one round
    round_ms = []
    for fb, b in [data.batch() for _ in range(3)]:
        trainer.train_step(fb, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(st.sync_now().values())
        round_ms.append(((time.perf_counter() - t0) * 1e3, n))
    log(f"streaming push: {steps} steps in {run_s:.3f} s, {res['sync_rounds']} "
        f"rounds, rows pushed by push {[len(f) for _, f in sync.pushes]}, "
        f"{len(pushed)} distinct; every pushed row equals the trainer's; a "
        f"round after one more step (ms, rows): "
        f"{[(round(ms, 3), n) for ms, n in round_ms]}; launches {launches}")
    return launches


def phase_delta_and_swap(trainer, restored, data, model, work, since_ts):
    """10d: the rows touched since `since_ts` travel as a delta into the
    trainer that 10a restored; then a second export and a hot swap."""
    import torch
    from monolith_tpu_torch import ops
    from monolith_tpu_torch.ops import scatter as rows_ops
    from monolith_tpu_torch.serving import export_model
    from monolith_tpu_torch.training import checkpoint
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    path = checkpoint.save_delta(trainer, work, since_ts=since_ts,
                                 base_step=restored.step)
    save_s = time.perf_counter() - t0
    assert ops.launch_counts()["gather_rows"] == 1, ops.launch_counts()
    z = np.load(os.path.join(path, "sparse-s0.npz"))
    fids, values = z["fids"], torch.from_numpy(z["values"]).cuda()
    # K1 gathered the saved values: they equal the plain version's
    assert torch.equal(values, _trainer_rows_plain(trainer, "sparse", fids))
    expect = restored.table_states["sparse"]["data"].clone()
    t0 = time.perf_counter()
    applied = checkpoint.restore_delta(restored, path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    assert launches == {"gather_rows": 2, "scatter_rows": 1,
                        "stochastic_round_bf16": 0}, launches
    assert applied == len(fids) > 0 and restored.step == trainer.step
    # what restore_delta's K1 and K2 did to the pool, by the plain versions
    # on a copy of the pool from before: the params columns of the delta's
    # rows overwritten, every other element as it was
    rows = torch.from_numpy(np.ascontiguousarray(
        restored.engine.stores["sparse"].lookup(fids), np.int32)).cuda()
    assert (rows >= 0).all()
    packed = rows_ops.gather_rows_plain(expect, rows)
    packed[:, :values.shape[1]] = values
    rows_ops.scatter_rows_plain(expect, rows, packed)
    assert torch.equal(restored.table_states["sparse"]["data"], expect), \
        "restore_delta's pool differs from the plain versions'"
    assert torch.equal(_trainer_rows_plain(restored, "sparse", fids), values)
    del expect, packed
    log(f"delta: {len(fids)} rows since ts {since_ts}, save {save_s:.3f} s, "
        f"restore {restore_s:.3f} s, {_tree_bytes(path)} bytes; the saved "
        f"values and the restored pool equal the plain versions' bit for "
        f"bit; launches {launches}")
    for _ in range(8):
        trainer.train_step(*data.batch())
    probe = data.batch()
    old = model.predict(*probe)
    path2 = export_model(trainer, work)
    t0 = time.perf_counter()
    assert model.reload_export(path2) == trainer.step == model.step
    swap_s = time.perf_counter() - t0
    new = model.predict(*probe)
    np.testing.assert_allclose(new, trainer.predict(*probe).cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    assert not np.allclose(old, new)
    log(f"hot swap: reload_export in {swap_s:.3f} s, the model serves step "
        f"{model.step} and its predictions follow the new export")
    return launches


def phase_serving_card_vs_cpu(work):
    """10e: one export of a small trainer, served from the card and from
    the CPU: predictions rtol 1e-5."""
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.serving import ServingModel, export_model
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig
    task = DeepFMTask(embedding_dim=8, capacity_per_shard=4096,
                      hidden=(16, 8))
    trainer = Trainer(task, TrainerConfig(engine=EngineConfig(
        unique_cap=512, new_cap=512), log_every=0, seed=51), device="cpu")
    data = SyntheticCTR(num_users=80, num_items=40, batch_size=128, seed=51)
    for _ in range(20):
        trainer.train_step(*data.batch())
    path = export_model(trainer, os.path.join(work, "small"))
    card = ServingModel(task, path, unique_cap=512)
    cpu = ServingModel(task, path, unique_cap=512, device="cpu")
    gaps = []
    for _ in range(3):
        fb, b = data.batch()
        pc, pg = cpu.predict(fb, b), card.predict(fb, b)
        np.testing.assert_allclose(pg, pc, rtol=1e-5)
        gaps.append(float(np.max(np.abs(pg / pc - 1))))
    log(f"serving card vs cpu: worst relative gap {max(gaps):.3e}")


def phase_out_of_the_trainer(deepfm, multislot):
    """Phases 10a-10d on the trainers that phases 5b and 5c left; returns
    the kernels' launches of the serving side by path."""
    import shutil
    import tempfile

    import torch
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.time()
        trainer, data = deepfm["trainer"], deepfm["data"]
        restored = phase_checkpoint(trainer, deepfm["seen"], work)
        # headroom 1.5: this stream brings ~21,000 new ids a step, and
        # 10b-10c push ~36 batches' worth of them into the serving pool
        model, serve = phase_export_serve("deepfm_f32", trainer, data, work,
                                          32768, 8, 1e-4, headroom=1.5)
        since_ts = int(time.time())
        streaming = phase_streaming(trainer, data, model)
        delta = phase_delta_and_swap(trainer, restored, data, model, work,
                                     since_ts)
        del restored, model
        torch.cuda.empty_cache()
        _, ms_serve = phase_export_serve(
            "multislot_bf16", multislot["trainer"], multislot["data"],
            os.path.join(work, "ms"), 49152, 4, 1e-3)
        phase_serving_card_vs_cpu(work)
        log(f"phases 10a-10e: {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"deepfm_f32": {k: serve[k] + streaming[k] + delta[k]
                           for k in streaming},
            "multislot_bf16": ms_serve}


# ----------------------------------------------------------------------
# phase 11: expiry and tiered storage at full width
# ----------------------------------------------------------------------

EXPIRY_TTL, EXPIRY_STEPS, EXPIRE_BEFORE = 8, 16, 8


class Launches:
    """Kernel launches of the driven runs only: each run is counted from 0
    and the counts are added up; the checks against the plain versions run
    between the runs, uncounted."""

    def __init__(self):
        self.total = {}

    def run(self, fn):
        from monolith_tpu_torch import ops
        _sync()
        ops.reset_launch_counts()
        out = fn()
        _sync()
        self.add(ops.launch_counts())
        return out

    def add(self, counts):
        for k, v in counts.items():
            self.total[k] = self.total.get(k, 0) + v


def _sync():
    """Wait for the card, in a process that uses it (a rank process on the
    CPU never does)."""
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _steps(trainer, batches, ts0, launches):
    """Train steps at ts = ts0, ts0 + 1, ...; returns (losses, median ms a
    step with a synchronize after each)."""
    losses, times = [], []
    for i, (fb, b) in enumerate(batches):
        def one():
            t0 = time.perf_counter()
            out = trainer.train_step(fb, b, ts=ts0 + i)
            _sync()
            times.append((time.perf_counter() - t0) * 1e3)
            return out
        out = launches.run(one)
        losses.append(out["loss"].item())
        assert not any(out["stats"]["overflow"].values()), out["stats"]
    assert np.isfinite(losses).all(), losses
    return losses, float(np.median(times))


def _spy_lookup(trainer):
    """Record what fused_lookup hands the model at each call: the packed
    rows and the decoded inputs. Returns (records, the real method)."""
    seen = []
    real = trainer.engine.fused_lookup

    def spy(states, inputs, seed, step):
        prows, unique = real(states, inputs, seed, step)
        seen.append((prows, inputs))
        return prows, unique

    trainer.engine.fused_lookup = spy
    return seen, real


def _plain_rows(trainer, rows):
    """Packed rows of the DeepFM pool read by K1's plain version."""
    import torch
    from monolith_tpu_torch.ops import scatter as ops
    return ops.gather_rows_plain(
        trainer.table_states["sparse"]["data"],
        torch.from_numpy(np.ascontiguousarray(rows, np.int32)).cuda())


def _revived(inputs):
    pos = inputs["sparse"].get("revive_pos")
    return 0 if pos is None else int((pos >= 0).sum())


def phase_expiry(launches):
    """11a: the deepfm_f32 cell with a ttl of 8: 16 steps at ts = step,
    evict_expired(8), then 4 steps whose new ids take recycled rows.
    Returns (trainer, untiered per-step ms/step)."""
    import torch
    from monolith_tpu_torch.ops import scatter as ops
    from monolith_tpu_torch.profile_step import CONFIGS
    trainer, data = CONFIGS["deepfm"](ttl_seconds=EXPIRY_TTL)
    spec, task = trainer.engine.tables["sparse"], trainer.task
    batches = [data.batch() for _ in range(EXPIRY_STEPS + 4)]
    _steps(trainer, batches[:EXPIRY_STEPS], 0, launches)
    store = trainer.engine.stores["sparse"]
    _, rows, tss, _ = store.save()
    survive = torch.from_numpy(rows[tss >= EXPIRE_BEFORE]).cuda()
    size0 = store.size()
    pool = trainer.table_states["sparse"]["data"]
    kept = ops.gather_rows(pool, survive)
    timed = {}
    engine = trainer.engine
    real_evict, real_zero = engine.evict_expired, engine.zero_rows

    def evict(expire_before):
        t0 = time.perf_counter()
        out = real_evict(expire_before)
        timed["evict_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    def zero(states, freed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_zero(states, freed)
        torch.cuda.synchronize()
        timed["zero_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    engine.evict_expired, engine.zero_rows = evict, zero
    freed = launches.run(lambda: trainer.evict_expired(EXPIRE_BEFORE))
    engine.evict_expired, engine.zero_rows = real_evict, real_zero
    freed = freed["sparse"]
    n = len(freed)
    assert n > 0 and store.size() == size0 - n, (n, size0, store.size())
    freed_t = torch.from_numpy(freed.astype(np.int32)).cuda()
    got = ops.gather_rows(pool, freed_t)
    assert not got.any(), "a freed row does not read zero"
    assert torch.equal(got, _plain_rows(trainer, freed))
    assert torch.equal(ops.gather_rows(pool, survive), kept), \
        "a surviving row changed"
    del got, kept
    # the first step after: new ids that took recycled rows get init values
    seen, real = _spy_lookup(trainer)
    losses, step_ms = _steps(trainer, batches[EXPIRY_STEPS:], EXPIRY_STEPS,
                             launches)
    engine.fused_lookup = real
    prows, inputs = seen[0]
    tin = inputs["sparse"]
    took = (tin["new_mask"] > 0) & torch.isin(tin["rows"], freed_t)
    p = prows["sparse"][took]
    recycled = int(took.sum())
    assert recycled > 0, "no new id took a recycled row"
    d, e = spec.dim, task.embedding_dim
    assert (p[:, 0] == 0).all(), "a recycled row's bias is not 0"
    assert (p[:, 1:d].abs() <= task.init_scale).all()
    assert (p[:, d:d + e] == torch.tensor(task.accumulator_init,
                                          dtype=torch.float32)).all()
    assert not p[:, d + e:].any()
    log(f"11a expiry (deepfm_f32, ttl {EXPIRY_TTL}, {EXPIRY_STEPS} steps at "
        f"ts = step): evict_expired({EXPIRE_BEFORE}) freed {n} of {size0} "
        f"rows; host evict {timed['evict_ms']:.3f} ms; zero_rows one K2 of "
        f"{1 << (n - 1).bit_length()} rows ({n} valid) "
        f"{timed['zero_ms']:.3f} ms (synchronized); freed rows read zero "
        f"(K1 = plain), survivors unchanged; next {len(losses)} losses "
        f"{np.round(losses, 5).tolist()}; {recycled} new ids on recycled "
        f"rows hold init values; untiered per-step path {step_ms:.3f} "
        f"ms/step (median, synchronized)")
    return trainer, step_ms


def phase_tiered(untiered, untiered_ms, launches, work):
    """11b: the same cell tiered: 16 steps, spill_expired(8), 2 steps that
    revive spilled user ids, 4 more, a checkpoint round trip of the
    archive, then the tiered host prepare against prepare_wire."""
    import torch
    from monolith_tpu_torch.embedding.tiered import state_width
    from monolith_tpu_torch.profile_step import CONFIGS
    from monolith_tpu_torch.training import checkpoint
    trainer, data = CONFIGS["deepfm"](ttl_seconds=EXPIRY_TTL, tiered=True)
    width = state_width(trainer.engine.tables["sparse"])
    archive = trainer.engine.archives["sparse"]
    _steps(trainer, [data.batch() for _ in range(EXPIRY_STEPS)], 0, launches)
    store = trainer.engine.stores["sparse"]
    fids, rows, tss, _ = store.save()
    old = tss < EXPIRE_BEFORE
    want = dict(zip(fids[old].tolist(),
                    _plain_rows(trainer, rows[old])[:, :width].cpu().numpy()))
    t0 = time.perf_counter()
    spilled = launches.run(lambda: trainer.spill_expired(EXPIRE_BEFORE))
    spill_s = time.perf_counter() - t0
    n_spilled = spilled["sparse"]
    assert n_spilled == int(old.sum()) == archive.size(), \
        (spilled, archive.size())
    a_fids, a_rows, _, _ = archive.map.save()
    for f, v in zip(a_fids.tolist(), archive.values[a_rows]):
        assert np.array_equal(v.view(np.int32), want[f].view(np.int32)), f
    assert not _plain_rows(trainer, rows[old]).any(), "spilled rows not zero"
    entry_bytes = len(a_fids) * (width * 4 + 8 + 4 + 4)
    # 2 steps whose user_id column holds spilled user ids (slot 1)
    users = a_fids[(a_fids >> 54) == 1]
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(2):
        fb, b = data.batch()
        batches.append((dict(fb, user_id=rng.choice(
            users, (len(b["label"]), 1), replace=False)), b))
    archived = {f: archive.values[r].copy()
                for f, r in zip(a_fids.tolist(), a_rows.tolist())}
    revive_bytes = []
    prepare = trainer.engine.prepare_batch

    def measured_prepare(fid_batch, ts):
        inputs, stats = prepare(fid_batch, ts)
        tin = inputs["sparse"]
        revive_bytes.append(tin["revive_pos"].nbytes
                            + tin["revive_values"].nbytes)
        return inputs, stats

    trainer.engine.prepare_batch = measured_prepare
    seen, real = _spy_lookup(trainer)
    before = archive.revived
    losses, _ = _steps(trainer, batches, EXPIRY_STEPS, launches)
    trainer.engine.prepare_batch, trainer.engine.fused_lookup = prepare, real
    revived_step = [_revived(inputs) for _, inputs in seen]
    assert archive.revived - before == sum(revived_step), \
        (archive.revived, before, revived_step)
    assert revived_step[0] >= len(batches[0][1]["label"]), revived_step
    # the revive step: every revived row handed to the model is the
    # archived state, bit for bit, and the columns after it read zero
    prows, inputs = seen[0]
    tin = inputs["sparse"]
    pos = tin["revive_pos"][tin["revive_pos"] >= 0].long()
    probe = np.array(list(archived), np.int64)
    fid_of_row = dict(zip(store.lookup(probe).tolist(), probe.tolist()))
    handed = prows["sparse"][pos].cpu().numpy()
    for r, h in zip(tin["rows"][pos].cpu().tolist(), handed):
        assert np.array_equal(h[:width].view(np.int32),
                              archived[fid_of_row[r]].view(np.int32)), r
        assert not h[width:].any()
    # the tiered per-step path, beside 11a's untiered one
    more = [data.batch() for _ in range(4)]
    _, tiered_ms = _steps(trainer, more, EXPIRY_STEPS + 2, launches)
    wire_bytes = 4 * trainer._full_wire_words(
        trainer._batch_layout(more[0][1]))
    # checkpoint round trip of the archive
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = checkpoint.save(trainer, work)
    save_s = time.perf_counter() - t0
    fresh, _ = CONFIGS["deepfm"](ttl_seconds=EXPIRY_TTL, tiered=True)
    t0 = time.perf_counter()
    checkpoint.restore(fresh, work)
    restore_s = time.perf_counter() - t0
    other = fresh.engine.archives["sparse"]
    a_fids, a_rows, _, _ = archive.map.save()
    b_fids, b_rows, _, _ = other.map.save()
    oa, ob = np.argsort(a_fids), np.argsort(b_fids)
    assert np.array_equal(a_fids[oa], b_fids[ob])
    assert np.array_equal(archive.values[a_rows[oa]], other.values[b_rows[ob]])
    assert np.array_equal(archive.tss[a_rows[oa]], other.tss[b_rows[ob]])
    del fresh, other
    # host prepare a step, alternating: prepare_batch + pack_wire on the
    # tiered engine, prepare_wire on 11a's untiered engine, on the same
    # fresh batches (last: these prepares admit ids no step trains)
    tiered_host, revive_host, wire_host = [], [], []
    real_revive = archive.revive

    def timed_revive(fids):
        t0 = time.perf_counter()
        out = real_revive(fids)
        revive_host[-1] += (time.perf_counter() - t0) * 1e3
        return out

    archive.revive = timed_revive
    for i in range(6):
        fb, _ = data.batch()
        revive_host.append(0.0)
        t0 = time.perf_counter()
        trainer.engine.pack_wire(trainer.engine.prepare_batch(fb, 100 + i)[0])
        tiered_host.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        untiered.engine.prepare_wire(fb, ts=100 + i)
        wire_host.append((time.perf_counter() - t0) * 1e3)
    archive.revive = real_revive
    log(f"11b tiered (deepfm_f32): spill_expired({EXPIRE_BEFORE}) spilled "
        f"{n_spilled} rows in {spill_s:.3f} s (one K1 of "
        f"{1 << (n_spilled - 1).bit_length()} rows, one zeroing K2); archive "
        f"{len(a_fids)} entries after the revives, {entry_bytes} bytes of "
        f"entries ({archive.values.nbytes} bytes of values allocated); "
        f"archived values = plain gather bit for bit, spilled rows zero; "
        f"revived rows a step {revived_step}, losses "
        f"{np.round(losses, 5).tolist()}; every revived row handed to the "
        f"model = its archived state bit for bit; upload a step: wire "
        f"{wire_bytes} bytes + revive {revive_bytes} bytes; per-step path "
        f"ms/step (median, synchronized): tiered {tiered_ms:.3f}, untiered "
        f"{untiered_ms:.3f}; host prepare ms a step, alternating (median "
        f"of 6): prepare_batch + pack_wire {np.median(tiered_host):.3f} "
        f"(of it RowArchive.revive {np.median(revive_host):.3f}), "
        f"prepare_wire {np.median(wire_host):.3f}; checkpoint with the "
        f"archive: save {save_s:.3f} s, restore {restore_s:.3f} s, "
        f"{_tree_bytes(path)} bytes, restored archive equal")


def phase_tiered_card_vs_cpu():
    """11c: a small tiered DeepFM (capacity 256, batch 64, init_scale 0.0)
    from one state on the card and on the CPU: train, spill, train other
    ids, revive, train. Losses rtol 1e-4, pools rtol 1e-5 (atol 1e-6);
    archives, stores and counters equal."""
    from monolith_tpu_torch import convert
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

    def make(device):
        return Trainer(DeepFMTask(embedding_dim=8, capacity_per_shard=256,
                                  hidden=(16,), ttl_seconds=3600,
                                  init_scale=0.0),
                       TrainerConfig(engine=EngineConfig(
                           unique_cap=256, new_cap=256, tiered=True),
                           log_every=0), device=device)

    def batch(ids):
        ids = np.asarray(ids, np.int64)[:, None]
        return ({"user_id": ids, "item_id": ids + 10_000,
                 "hist_items": np.full((len(ids), 10), -1, np.int64)},
                {"label": (ids[:, 0] % 3 == 0).astype(np.float32)})

    cpu, card = make("cpu"), make("cuda")
    convert.load_state(card, convert.export_state(cpu))
    a, b = batch(np.arange(1, 65)), batch(np.arange(200, 264))
    gaps = []
    for what, pair, ts in [("step", a, 100), ("step", a, 101),
                           ("spill", None, 200), ("step", b, 300),
                           ("step", a, 400), ("step", a, 500)]:
        if what == "spill":
            assert cpu.spill_expired(ts) == card.spill_expired(ts)
            continue
        lc = cpu.train_step(*pair, ts=ts)["loss"].item()
        lg = card.train_step(*pair, ts=ts)["loss"].item()
        np.testing.assert_allclose(lg, lc, rtol=1e-4)
        gaps.append(abs(lg / lc - 1))
    sc, sg = convert.export_state(cpu), convert.export_state(card)
    for x, y in zip(sc["stores"]["sparse"], sg["stores"]["sparse"]):
        assert np.array_equal(x, y)
    np.testing.assert_allclose(sg["tables"]["sparse"], sc["tables"]["sparse"],
                               rtol=1e-5, atol=1e-6)
    ac, ag = (convert.export_archives(t)["sparse"] for t in (cpu, card))
    for k in ("fids", "rows", "map_tss", "tss", "spilled", "revived",
              "dropped"):
        assert np.array_equal(ag[k], ac[k]), k
    np.testing.assert_allclose(ag["values"], ac["values"], rtol=1e-5,
                               atol=1e-6)
    assert card.engine.archives["sparse"].revived == 128
    log(f"11c tiered card vs cpu: losses' worst relative gap "
        f"{max(gaps):.3e}; stores, archives and counters equal; pools within "
        f"rtol 1e-5")


def phase_expiry_and_tiering():
    """Phases 11a-11c; returns the kernels' launches of 11a's and 11b's
    driven runs (train steps, evict_expired, spill_expired)."""
    import shutil
    import tempfile

    import torch
    work = tempfile.mkdtemp(prefix="chip_smoke_tiered_")
    launches = Launches()
    try:
        t0 = time.time()
        untiered, untiered_ms = phase_expiry(launches)
        phase_tiered(untiered, untiered_ms, launches, work)
        del untiered
        torch.cuda.empty_cache()
        phase_tiered_card_vs_cpu()
        log(f"phases 11a-11c: {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # one K1 and one K2 a step (11a: 16 + 4, 11b: 16 + 2 + 4), the zeroing
    # K2 of the eviction, the spill's K1 and zeroing K2, and no K3
    steps = (EXPIRY_STEPS + 4) + (EXPIRY_STEPS + 2 + 4)
    expect = {"gather_rows": steps + 1, "scatter_rows": steps + 2,
              "stochastic_round_bf16": 0}
    assert launches.total == expect, (launches.total, expect)
    return launches.total


# ----------------------------------------------------------------------
# phase 12: the front door (files, the CLI, the Estimator) at full width
# ----------------------------------------------------------------------

FILE_BATCHES, FILE_BATCH = 8, 8192
#: bench.py's deepfm config as the CLI's --task_args
CLI_TASK_ARGS = {"embedding_dim": 16, "capacity_per_shard": 1 << 21,
                 "hidden": [256, 128, 64]}
CLI_STEPS, CLI_EVALS, CLI_K = 6, 2, 3
#: the JAX package's eval AUC on its frozen MovieRanking configuration
#: (monolith_tpu_torch/parity.py's PARITY), `train_monolith(
#: *frozen_data())` of monolith_tpu/parity.py, measured on the CPU (JAX
#: 0.9.0) at commit 2239d4d by `JAX_PLATFORMS=cpu python -c "from
#: monolith_tpu.parity import train_monolith, frozen_data;
#: print(train_monolith(*frozen_data()))"` (the card machine has no JAX)
JAX_PARITY_AUC = 0.8867084622810547


def _wall(fn):
    """(fn(), seconds on the host clock)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _launches_of(fn):
    """(fn(), the kernels' launches in it), counted from 0."""
    launches = Launches()
    out = launches.run(fn)
    return out, launches.total


def phase_files(work):
    """12a: 8 batches of bench.py's deepfm stream as 65,536 Examples (the
    -1 pads dropped, as a producer writes them) in a framed mtex file, and
    the first batch as one pb_example_batch record; both read back through
    FileSource + BatchedDataset equal the generator's batches. Returns
    (the mtex batches read back, host ms a batch by format)."""
    from monolith_tpu_torch.data import pb_compat
    from monolith_tpu_torch.data.datasets import BatchedDataset, FileSource
    from monolith_tpu_torch.data.example import Example
    from monolith_tpu_torch.data.framing import (RecordWriter,
                                                 write_example_file)
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    gen = SyntheticCTR(num_users=1_000_000, num_items=200_000,
                       batch_size=FILE_BATCH, seed=0)
    batches = [gen.batch() for _ in range(FILE_BATCHES)]
    exs, build_s = _wall(lambda: [
        Example(features={k: v[i][v[i] >= 0] for k, v in fb.items()},
                labels=np.asarray([b["label"][i]], np.float32))
        for fb, b in batches for i in range(FILE_BATCH)])
    mtex, pb = os.path.join(work, "part-0.rec"), os.path.join(work, "batch.pb")
    n, mtex_s = _wall(lambda: write_example_file(mtex, exs))
    assert n == FILE_BATCHES * FILE_BATCH

    def write_pb():
        with open(pb, "wb") as f:
            RecordWriter(f).write(pb_compat.encode_example_batch(
                exs[:FILE_BATCH]))
    _, pb_s = _wall(write_pb)
    lengths = {f.name: f.max_length for f in DeepFMTask().features()}
    read, ms = {}, {}
    for fmt, path, want in (("mtex", mtex, FILE_BATCHES),
                            ("pb_example_batch", pb, 1)):
        it = iter(BatchedDataset(FileSource(path, fmt=fmt), FILE_BATCH,
                                 lengths))
        got, times = [], []
        for _ in range(want):
            pair, secs = _wall(lambda: next(it))
            got.append(pair)
            times.append(secs * 1e3)
        assert next(it, None) is None, fmt
        for (fb, b), (gf, gb) in zip(batches, got):
            assert sorted(fb) == sorted(gf), (fmt, sorted(gf))
            for k in fb:
                assert np.array_equal(fb[k], gf[k]), (fmt, k)
            assert np.array_equal(b["label"], gb["label"]), fmt
        read[fmt], ms[fmt] = got, float(np.median(times))
    log(f"12a files: {len(exs)} Examples built in {build_s * 1e3:.1f} ms; "
        f"written as mtex in {mtex_s * 1e3:.1f} ms ({os.path.getsize(mtex)} "
        f"B), one batch as pb_example_batch in {pb_s * 1e3:.1f} ms "
        f"({os.path.getsize(pb)} B); read back equal to the generator's "
        f"batches, host ms a batch of {FILE_BATCH} (FileSource + "
        f"BatchedDataset, median): mtex {ms['mtex']:.1f}, pb_example_batch "
        f"{ms['pb_example_batch']:.1f}")
    return read["mtex"], ms


def _cli_argv(work, mode, *extra):
    return ["--task", "deepfm", "--task_args", json.dumps(CLI_TASK_ARGS),
            "--data", f"files:{work}/part-*.rec",
            "--batch_size", str(FILE_BATCH), "--unique_cap", "32768",
            "--new_cap", "32768", "--mode", mode, "--log_every", "0",
            "--model_dir", os.path.join(work, "model"), *extra]


def phase_cli(work, file_batches, read_ms):
    """12b: bench.py's deepfm config trained by `train.main` on the files
    (6 steps in blocks of 3, 2 eval batches, the Estimator's checkpoint at
    the end of train, an export that the card's ServingModel loads); the
    same trainer alone on the batches in memory for comparison. 12c: a
    second `train.main --mode eval` restores step 6 and evaluates the
    file's first 2 batches, as a direct checkpoint.restore into a fresh
    Trainer does (loss and AUC to 1e-6 relative). Returns the launches of
    both CLI runs."""
    import torch
    from monolith_tpu_torch import train
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.profile_step import CONFIGS
    from monolith_tpu_torch.serving.engine import ServingModel
    from monolith_tpu_torch.training import checkpoint
    (out, cli_s), launches = _launches_of(lambda: _wall(lambda: train.main(
        _cli_argv(work, "train_and_eval", "--steps", str(CLI_STEPS),
                  "--eval_steps", str(CLI_EVALS), "--steps_per_dispatch",
                  str(CLI_K), "--export_dir", os.path.join(work, "export")))))
    # K1 a step, an eval batch and the export (one table); K2 a step
    expect = {"gather_rows": CLI_STEPS + CLI_EVALS + 1,
              "scatter_rows": CLI_STEPS, "stochastic_round_bf16": 0}
    assert launches == expect, (launches, expect)
    assert np.isfinite(out["train"]["loss"]) and np.isfinite(
        out["eval"]["loss"]), out
    model_dir = os.path.join(work, "model")
    assert os.path.exists(os.path.join(model_dir, "CHECKPOINT"))
    assert checkpoint.latest_step(model_dir) == CLI_STEPS
    model = ServingModel(DeepFMTask(**CLI_TASK_ARGS), out["export_path"],
                         unique_cap=32768)
    preds = model.predict(*file_batches[0])
    assert preds.shape == (FILE_BATCH,) and np.isfinite(preds).all()
    del model

    trainer, _ = CONFIGS["deepfm"](steps_per_dispatch=CLI_K)
    packs = []
    real_prepare = trainer.engine.prepare_wire

    def timed_prepare(*a, **kw):
        res, secs = _wall(lambda: real_prepare(*a, **kw))
        packs.append(secs * 1e3)
        return res
    trainer.engine.prepare_wire = timed_prepare
    _, alone_s = _wall(lambda: (trainer.train(
        iter(file_batches[:CLI_STEPS]), steps=CLI_STEPS),
        torch.cuda.synchronize()))
    del trainer
    torch.cuda.empty_cache()
    cli_ms = FILE_BATCH / out["train"]["examples_per_sec"] * 1e3
    log(f"12b cli: train.main (train_and_eval, {CLI_STEPS} steps in blocks "
        f"of {CLI_K}, {CLI_EVALS} eval batches, checkpoint, export) "
        f"{cli_s:.3f} s; train {out['train']}; eval {out['eval']}; train "
        f"loop {cli_ms:.3f} ms/step with the files' decode (Estimator."
        f"train's first batch read before it); the trainer alone on the "
        f"same batches in memory {alone_s / CLI_STEPS * 1e3:.3f} ms/step "
        f"(host clock, one synchronize at the end), of which prepare_wire "
        f"{np.median(packs):.3f} ms a batch (median) beside the files' "
        f"{read_ms['mtex']:.1f} (mtex) and {read_ms['pb_example_batch']:.1f}"
        f" (pb_example_batch) ms a batch; serving predicts [{FILE_BATCH}] "
        f"from the export; launches {launches}")

    (out_c, eval_s), launches_c = _launches_of(lambda: _wall(
        lambda: train.main(_cli_argv(work, "eval", "--eval_steps",
                                     str(CLI_EVALS)))))
    assert launches_c == {"gather_rows": CLI_EVALS, "scatter_rows": 0,
                          "stochastic_round_bf16": 0}, launches_c
    direct, _ = CONFIGS["deepfm"]()
    assert checkpoint.restore(direct, model_dir) == CLI_STEPS
    ref = direct.evaluate(iter(file_batches[:CLI_EVALS]))
    del direct
    torch.cuda.empty_cache()
    for k in ("loss", "auc"):
        assert abs(out_c["eval"][k] - ref[k]) <= 1e-6 * abs(ref[k]), \
            (k, out_c["eval"], ref)
    log(f"12c restore through the Estimator: train.main --mode eval "
        f"{eval_s:.3f} s, eval {out_c['eval']}; a direct checkpoint.restore "
        f"+ Trainer.evaluate {ref}; launches {launches_c}")
    return {k: launches[k] + launches_c[k] for k in launches}


def phase_movielens(floor):
    """12d: the README's real-data command (`--task movie_ranking --data
    movielens:examples/movielens/ratings.dat --mode train_and_eval --steps
    800 --batch_size 512`) through `train.main` on the card; then the
    quality gate on the JAX package's frozen configuration: the eval AUC
    within PARITY_BAND of JAX_PARITY_AUC; then K1/K2 at the CLI's shapes
    (the user table's pool and its rows of the last step: unique_cap 8192,
    RunnerConfig's default), as phase 3. Returns (the kernels' entries,
    their case)."""
    import torch
    from monolith_tpu_torch import parity, train
    from monolith_tpu_torch.embedding.engine import EmbeddingEngine
    seen = {}
    real_lookup = EmbeddingEngine.fused_lookup

    def spy(self, states, inputs, seed, step):
        seen["states"], seen["inputs"] = states, inputs
        return real_lookup(self, states, inputs, seed, step)
    EmbeddingEngine.fused_lookup = spy
    try:
        (out, cli_s), launches = _launches_of(lambda: _wall(
            lambda: train.main(["--task", "movie_ranking", "--data",
                                f"movielens:{parity.MOVIELENS}", "--mode",
                                "train_and_eval", "--steps", "800",
                                "--batch_size", "512", "--log_every", "0"])))
    finally:
        EmbeddingEngine.fused_lookup = real_lookup
    # two tables: K1 a table a step and an eval batch (50, the CLI's
    # default), K2 a table a step
    expect = {"gather_rows": 2 * (800 + 50), "scatter_rows": 2 * 800,
              "stochastic_round_bf16": 0}
    assert launches == expect, (launches, expect)
    assert np.isfinite(out["train"]["loss"]) and np.isfinite(
        out["eval"]["loss"]), out
    eps = out["train"]["examples_per_sec"]
    log(f"12d movie_ranking cli: train.main {cli_s:.3f} s; "
        f"{512 / eps * 1e3:.3f} ms/step, {eps:.0f} examples/s; train "
        f"{out['train']}; eval AUC {out['eval']['auc']:.4f} (50 batches "
        f"of the training split, as the JAX CLI reads them); launches "
        f"{launches}")

    p = parity.PARITY
    auc, gate_s = _wall(lambda: parity.train_port(*parity.frozen_data()))
    log(f"12d quality gate (parity.py's frozen configuration, "
        f"{p['steps']} steps + {p['eval_steps']} eval batches in "
        f"{gate_s:.1f} s): eval AUC {auc:.6f} against the JAX package's "
        f"{JAX_PARITY_AUC:.6f} (band {parity.PARITY_BAND})")
    assert abs(auc - JAX_PARITY_AUC) <= parity.PARITY_BAND, \
        (auc, JAX_PARITY_AUC)

    pool = seen["states"]["emb_user_id"]["data"]
    rows = seen["inputs"]["emb_user_id"]["rows"]
    g = torch.Generator(device=pool.device).manual_seed(0)
    values = torch.randn((rows.shape[0], pool.shape[1]), generator=g,
                         device=pool.device)
    case = (pool, rows, values)
    entries = phase_rows("movie_ranking", floor, case)
    for k in entries:
        k["launches_by_path"] = {"cli": launches[k["name"]]}
    return entries, case


def phase_front_door(floor):
    """Phases 12a-12d; returns (the deepfm CLI runs' launches, the
    MovieRanking kernels' entries, their case)."""
    import shutil
    import tempfile

    import torch
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        t0 = time.time()
        file_batches, read_ms = phase_files(work)
        cli_launches = phase_cli(work, file_batches, read_ms)
        del file_batches
        torch.cuda.empty_cache()
        entries, case = phase_movielens(floor)
        log(f"phases 12a-12d: {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return cli_launches, entries, case


# ----------------------------------------------------------------------
# phase 13: the realtime loop over localhost gRPC at full width
# ----------------------------------------------------------------------

RT_PRE_STEPS, RT_STEPS, RT_EVERY, RT_MORE = 4, 24, 8, 8
RT_ROUTED_ROWS = 4096
#: the agent's pool grows by ~21,000 ids a step of this stream; after 4
#: steps' rows (~85,000) it needs room for ~30 more steps' pushes
RT_HEADROOM = 16.0


def _recording_sync(model_name, discovery):
    """The real SyncClientManager, each push's (table, fids, acks, host ms)
    kept."""
    from monolith_tpu_torch.serving import SyncClientManager

    class Recording(SyncClientManager):
        def __init__(self):
            super().__init__(model_name, discovery=discovery)
            self.pushes = []

        def push(self, table, fids, values):
            t0 = time.perf_counter()
            acks = super().push(table, fids, values)
            self.pushes.append((table, fids.copy(), acks,
                                (time.perf_counter() - t0) * 1e3))
            return acks
    return Recording()


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def phase_realtime_push(trainer, data, work, launches):
    """13a: export, an agent that registers in discovery, a streaming run
    whose pushes travel over gRPC. Returns (the agent, its client, the
    discovery, the in-process round ms)."""
    import torch
    from monolith_tpu_torch.serving import (FileDiscovery, ServingAgent,
                                            ServingClient, ServingModel,
                                            export_model)
    from monolith_tpu_torch.training.streaming import (StreamingConfig,
                                                       StreamingTrainer)
    task = trainer.task
    pre = [data.batch() for _ in range(RT_PRE_STEPS)]
    launches.run(lambda: [trainer.train_step(fb, b) for fb, b in pre])
    path = launches.run(lambda: export_model(trainer, os.path.join(work,
                                                                    "export")))
    disc = FileDiscovery(os.path.join(work, "discovery"))
    model = ServingModel(task, path, unique_cap=32768, headroom=RT_HEADROOM)
    agent = ServingAgent(model, discovery=disc)
    addr = agent.start()
    assert disc.query("serving") == {0: addr}
    client = ServingClient(addr, timeout_s=60.0)
    sync = _recording_sync(task.name, disc)
    probe = data.batch()
    before = client.predict(*probe)
    st = StreamingTrainer(trainer, sync, StreamingConfig(
        sync_interval_steps=RT_EVERY, max_push_rows=1 << 22))
    rounds = []
    real_sync_now = st.sync_now

    def timed_sync_now():
        out, ms = _timed(real_sync_now)
        rounds.append((ms, sum(out.values())))
        return out
    st.sync_now = timed_sync_now
    batches = [data.batch() for _ in range(RT_STEPS)]
    counted = Launches()
    res, run_ms = _timed(lambda: counted.run(
        lambda: st.run(iter(batches), max_steps=RT_STEPS)))
    launches.add(counted.total)
    # one K1 and one K2 a train step; one K1 more for every non-empty
    # (table, round) gather, each of which ended in one push
    assert res["steps"] == RT_STEPS and len(sync.pushes) >= RT_STEPS // RT_EVERY
    assert counted.total == {"gather_rows": RT_STEPS + len(sync.pushes),
                             "scatter_rows": RT_STEPS,
                             "stochastic_round_bf16": 0}, counted.total
    for _, fids, acks, _ in sync.pushes:
        assert acks == {addr: len(fids)}, (acks, len(fids))
    assert res["pushed_rows"] == sum(len(f) for _, f, _, _ in sync.pushes)
    pushed = np.unique(np.concatenate([f for _, f, _, _ in sync.pushes]))
    _serving_rows_equal_trainer(model, trainer, "sparse", pushed)
    after = client.predict(*probe)
    assert after.shape == (len(probe[1]["label"]),) and np.isfinite(after).all()
    np.testing.assert_allclose(after, model.predict(*probe), rtol=1e-6)
    assert not np.allclose(before, after), "the push changed no prediction"
    # predicts at batch 8192, over gRPC and in process, in turns
    over, local = [], []
    for _ in range(5):
        fb, b = data.batch()
        over.append(_timed(lambda: client.predict(fb, b))[1])
        local.append(_timed(lambda: model.predict(fb, b))[1])
    # a round after one more step, over gRPC and in process, in turns
    st_local = StreamingTrainer(trainer, PushTo(model), StreamingConfig(
        sync_interval_steps=0))
    grpc_rounds, local_rounds = [], []
    for i in range(6):
        launches.run(lambda: trainer.train_step(*data.batch()))
        torch.cuda.synchronize()
        one = st_local.sync_now if i % 2 else real_sync_now
        got, ms = _timed(lambda: launches.run(one))
        (local_rounds if i % 2 else grpc_rounds).append(
            (ms, sum(got.values())))
    big = [(ms, n) for ms, n in rounds if n]
    sync.close()
    log(f"13a realtime push over gRPC: {RT_STEPS} steps in {run_ms:.3f} ms, "
        f"{res['sync_rounds']} rounds; (ms, rows) a round incl. the K1 "
        f"gather and the pushes {[(round(ms, 3), n) for ms, n in rounds]}, "
        f"{sum(n for _, n in big) / (sum(ms for ms, _ in big) / 1e3):.0f} "
        f"rows/s over the non-empty rounds; host ms of each push "
        f"{[round(ms, 3) for *_, ms in sync.pushes]}; every ack equals its "
        f"rows ({[len(f) for _, f, _, _ in sync.pushes]}), {len(pushed)} "
        f"distinct rows equal the trainer's; a round after one more step "
        f"(ms, rows): over gRPC "
        f"{[(round(ms, 3), n) for ms, n in grpc_rounds]}, in process "
        f"{[(round(ms, 3), n) for ms, n in local_rounds]}; ms a predict at "
        f"batch {len(probe[1]['label'])} (median of 5, in turns): over gRPC "
        f"{np.median(over):.3f}, in process {np.median(local):.3f}; "
        f"launches of the streaming run {counted.total}")
    return agent, client, disc, path


def phase_realtime_router(trainer, data, work, path):
    """13b: two row-shard replicas behind agents, a router over their
    clients, against one ServingModel of the same export."""
    from monolith_tpu_torch.embedding.host_store import shard_of_batch
    from monolith_tpu_torch.serving import (FileDiscovery, ServingAgent,
                                            ServingClient, ServingModel,
                                            SyncClientManager)
    from monolith_tpu_torch.serving.router import ShardedServingRouter
    task = trainer.task
    single = ServingModel(task, path, unique_cap=32768)
    disc = FileDiscovery(os.path.join(work, "discovery_shards"))
    shards = [ServingModel(task, path, unique_cap=32768, shard_index=s,
                           num_row_shards=2) for s in range(2)]
    sizes = [m.table_sizes()["sparse"] for m in shards]
    assert sum(sizes) == single.table_sizes()["sparse"] and min(sizes) > 0
    agents = [ServingAgent(m, discovery=disc, replica_index=s)
              for s, m in enumerate(shards)]
    try:
        addrs = [a.start() for a in agents]
        clients = {s: ServingClient(a, timeout_s=60.0)
                   for s, a in enumerate(addrs)}
        router = ShardedServingRouter(task, path, clients, unique_cap=32768)
        routed, alone = [], []
        for _ in range(3):
            fb, b = data.batch()
            got, ms = _timed(lambda: router.predict(fb, b))
            want, ms1 = _timed(lambda: single.predict(fb, b))
            assert got.shape == (len(b["label"]),) and np.isfinite(got).all()
            np.testing.assert_array_equal(got, want)
            routed.append(ms)
            alone.append(ms1)
        router.close()
        rng = np.random.default_rng(13)
        fids = rng.integers(1 << 50, 1 << 51, size=RT_ROUTED_ROWS,
                            dtype=np.int64)
        vals = rng.standard_normal((RT_ROUTED_ROWS, 17)).astype(np.float32)
        owner = shard_of_batch(fids, 2)
        routed_sync = SyncClientManager(task.name, discovery=disc)
        acks = routed_sync.push_routed("sparse", fids, vals, num_row_shards=2)
        routed_sync.close()
        assert acks == {addrs[s]: int((owner == s).sum()) for s in range(2)}
        for s, m in enumerate(shards):
            mine = owner == s
            np.testing.assert_array_equal(m.lookup_rows("sparse", fids[mine]),
                                          vals[mine])
            np.testing.assert_array_equal(
                m.lookup_rows("sparse", fids[~mine]), 0.0)
        for c in clients.values():
            c.close()
    finally:
        for a in agents:
            a.stop()
    log(f"13b row-sharded serving: shard rows {sizes} = the single model's "
        f"{single.table_sizes()['sparse']}; 3 routed predicts at batch 8192 "
        f"equal the single ServingModel's exactly; ms a predict (host clock, "
        f"in turns): routed over 2 gRPC shards {[round(x, 3) for x in routed]}"
        f", single in process {[round(x, 3) for x in alone]}; push_routed of "
        f"{RT_ROUTED_ROWS} rows acked {sorted(acks.values())}, each on its "
        f"owning shard only")


def phase_realtime_swap_and_control(trainer, data, work, agent, client,
                                    launches):
    """13c: a second export swapped in by the VersionWatcher, then the
    TrainingController."""
    import threading

    import torch
    from monolith_tpu_torch.serving import (ParameterSyncClient,
                                            VersionWatcher, export_model)
    from monolith_tpu_torch.training import checkpoint
    from monolith_tpu_torch.training.controller import (ControllerClient,
                                                        TrainingController)
    batches = [data.batch() for _ in range(RT_MORE)]
    launches.run(lambda: [trainer.train_step(fb, b) for fb, b in batches])
    base = os.path.join(work, "export")
    launches.run(lambda: export_model(trainer, base))
    model = agent.model
    probe = data.batch()
    old = client.predict(*probe)
    watcher = VersionWatcher(model, base, poll_s=999)
    swapped, swap_ms = _timed(watcher.poll_once)
    assert swapped and model.step == trainer.step and watcher.swaps == 1
    assert not watcher.poll_once()
    new = client.predict(*probe)
    np.testing.assert_allclose(new, trainer.predict(*probe).cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    assert not np.allclose(old, new)
    fids = np.arange(1 << 52, (1 << 52) + 16, dtype=np.int64)
    vals = np.full((16, 17), 0.125, np.float32)
    sync = ParameterSyncClient(agent.addr)
    assert sync.push(trainer.task.name, "sparse", fids, vals) == 16
    sync.close()
    np.testing.assert_array_equal(model.lookup_rows("sparse", fids), vals)
    log(f"13c hot swap: poll_once swapped to step {model.step} in "
        f"{swap_ms:.3f} ms; predicts over gRPC follow the new export; a "
        f"push after the swap applies")

    ckpt = os.path.join(work, "ckpt")
    ctl = TrainingController(trainer, ckpt_dir=ckpt)
    ctl_client = ControllerClient(ctl.start())
    try:
        status = ctl_client.get_status()
        assert status["step"] == trainer.step, status
        assert status["table:sparse:s0:size"] == \
            trainer.engine.stores["sparse"].size(), status
        s0 = trainer.step
        more = [data.batch() for _ in range(3)]
        counted = Launches()

        def controlled():
            assert ctl_client.stop_training()["paused"] == 1
            worker = threading.Thread(target=trainer.train, args=(
                iter(more[:2]),), kwargs={"steps": 2, "hooks": [ctl.hook]})
            worker.start()
            deadline = time.time() + 30
            while trainer.step < s0 + 1 and time.time() < deadline:
                time.sleep(0.01)
            time.sleep(0.3)
            held = trainer.step
            paused = ctl_client.get_status()["paused"]
            assert ctl_client.resume_training()["paused"] == 0
            worker.join(30)
            assert not worker.is_alive()
            assert ctl_client.save_checkpoint() == {"ok": 1}
            trainer.train(iter(more[2:]), steps=1, hooks=[ctl.hook])
            return held, paused
        (held, paused), ms = _timed(lambda: counted.run(controlled))
        launches.add(counted.total)
        assert held == s0 + 1 and paused == 1, (held, paused, s0)
        assert trainer.step == s0 + 3
        assert checkpoint.latest_step(ckpt) == s0 + 3
        # one K1 and one K2 a step; the save launches none
        assert counted.total == {"gather_rows": 3, "scatter_rows": 3,
                                 "stochastic_round_bf16": 0}, counted.total
        ctl_client.close()
    finally:
        ctl._paused.clear()
        ctl.stop()
    torch.cuda.synchronize()
    log(f"13c controller: status step {status['step']}, table size "
        f"{status['table:sparse:s0:size']}; paused at step {held} while a "
        f"train call on another thread waited in the hook, resumed to step "
        f"{s0 + 2}; SaveCheckpoint honoured at the next hook (ckpt-{s0 + 3}); "
        f"{ms:.3f} ms in all; launches {counted.total}")


def phase_realtime_demo(work, launches):
    """13d: the user's entry point, `demo --realtime` at its defaults."""
    from monolith_tpu_torch import demo
    counted = Launches()
    out, ms = _timed(lambda: counted.run(lambda: demo.main(
        ["--realtime", "--model_dir", os.path.join(work, "demo")])))
    launches.add(counted.total)
    res = out["realtime"]
    assert res["pushed_rows"] > 0 and res["steps"] == 100, res
    # K1: 500 steps, 20 eval batches, the export, 100 streaming steps and
    # one a non-empty round; K2: a step
    gathers = counted.total["gather_rows"] - (500 + 20 + 1 + 100)
    assert 1 <= gathers <= res["sync_rounds"], (counted.total, res)
    assert counted.total["scatter_rows"] == 600, counted.total
    assert counted.total["stochastic_round_bf16"] == 0, counted.total
    log(f"13d demo --realtime: {ms / 1e3:.3f} s; train {out['train']}; eval "
        f"{out['eval']}; realtime {res}; launches {counted.total}")


def phase_realtime():
    """Phases 13a-13d; returns the kernels' launches of the realtime
    path."""
    import shutil
    import tempfile

    import torch
    from monolith_tpu_torch.profile_step import CONFIGS
    work = tempfile.mkdtemp(prefix="chip_smoke_rt_")
    launches = Launches()
    agent = None
    try:
        t0 = time.time()
        trainer, data = CONFIGS["deepfm"](record_touch=True)
        agent, client, disc, path = phase_realtime_push(trainer, data, work,
                                                        launches)
        phase_realtime_router(trainer, data, work, path)
        phase_realtime_swap_and_control(trainer, data, work, agent, client,
                                        launches)
        client.close()
        agent.stop()
        assert disc.query("serving") == {}
        agent = None
        del trainer
        torch.cuda.empty_cache()
        phase_realtime_demo(work, launches)
        log(f"phases 13a-13d: {time.time() - t0:.1f} s")
    finally:
        if agent is not None:
            agent.stop()
        shutil.rmtree(work, ignore_errors=True)
    return launches.total


# ----------------------------------------------------------------------
# phase 14: the model zoo at full width
# ----------------------------------------------------------------------

#: variant -> (the CLI's --task, its --task_args beside the capacity)
ZOO = {"ffm": ("ffm", {}), "din": ("din", {}),
       "dien": ("din", {"seq_encoder": "dien"}), "mmoe": ("mmoe", {}),
       "dcn": ("dcn", {}), "autoint": ("autoint", {})}
#: the deepfm_f32 cell's engine: pool rows, unique_cap = new_cap, batch
ZOO_CAP, ZOO_U, ZOO_B = 1 << 21, 32768, 8192
#: CLI steps with --steps_per_dispatch 1, then 4; eval batches
ZOO_STEPS_K1, ZOO_STEPS_K4, ZOO_EVALS = 8, 16, 4
#: the measurement windows on the deepfm_f32 cell's stream
ZOO_WARM, ZOO_WINDOW = 2, 8
#: tests/test_models.py's sizes (task kwargs, data seed) for each variant:
#: the learning check and the card against the CPU
ZOO_SMALL = {
    "ffm": (dict(capacity_per_shard=8192), 31),
    "din": (dict(embedding_dim=8, capacity_per_shard=4096, hidden=(32, 16)),
            21),
    "dien": (dict(embedding_dim=8, capacity_per_shard=8192, hidden=(16,),
                  seq_encoder="dien"), 35),
    "mmoe": (dict(capacity_per_shard=8192), 32),
    "dcn": (dict(capacity_per_shard=8192), 33),
    "autoint": (dict(capacity_per_shard=8192), 34)}
ZOO_LEARN_STEPS, ZOO_DIN_AUC = 80, 0.53


def _expect_launches(got, want, what):
    want = {"gather_rows": 0, "scatter_rows": 0, "stochastic_round_bf16": 0,
            **want}
    assert got == want, (what, got, want)


def _zoo_task_args(name):
    task, extra = ZOO[name]
    return task, {**extra, "capacity_per_shard": ZOO_CAP}


def _zoo_cli(name, work, launches, device_args=()):
    """14a: `train.main` on the CLI's synthetic data (seed 0) at the task's
    widths and the deepfm_f32 engine: ZOO_STEPS_K1 steps one by one, then
    ZOO_STEPS_K4 in blocks of 4 ending in the Estimator's checkpoint and an
    export, then `--mode eval`. Returns (model_dir, export path, the three
    runs' JSON outputs)."""
    from monolith_tpu_torch import train
    task, args = _zoo_task_args(name)
    model_dir = os.path.join(work, name, "model")

    def cli(mode, *extra):
        return train.main(["--task", task, "--task_args", json.dumps(args),
                           "--batch_size", str(ZOO_B), "--unique_cap",
                           str(ZOO_U), "--new_cap", str(ZOO_U), "--mode",
                           mode, "--log_every", "0", "--model_dir",
                           model_dir, *extra, *device_args])
    outs = []
    for mode, extra, want in (
            ("train", ["--steps", str(ZOO_STEPS_K1)],
             {"gather_rows": ZOO_STEPS_K1, "scatter_rows": ZOO_STEPS_K1}),
            ("train", ["--steps", str(ZOO_STEPS_K4), "--steps_per_dispatch",
                       "4", "--export_dir", os.path.join(work, name,
                                                         "export")],
             # a step each, and the export's one gather
             {"gather_rows": ZOO_STEPS_K4 + 1, "scatter_rows": ZOO_STEPS_K4}),
            ("eval", ["--eval_steps", str(ZOO_EVALS)],
             {"gather_rows": ZOO_EVALS})):
        counted = Launches()
        out, secs = _wall(lambda: counted.run(lambda: cli(mode, *extra)))
        _expect_launches(counted.total, want, f"{name} cli {mode}")
        launches.add(counted.total)
        for part in ("train", "eval"):
            if part in out:
                assert all(np.isfinite(v) for v in out[part].values()), out
        outs.append((out, secs))
    return model_dir, outs[1][0]["export_path"], outs


def _zoo_restored(name, model_dir, device):
    """A Trainer of the variant at the CLI's engine, restored from the
    CLI's checkpoint, as a direct `checkpoint.restore` gives it."""
    from monolith_tpu_torch import train
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.training import checkpoint
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig
    task, args = _zoo_task_args(name)
    trainer = Trainer(train.build_task(task, args), TrainerConfig(
        engine=EngineConfig(unique_cap=ZOO_U, new_cap=ZOO_U), log_every=0),
        device=device)
    assert checkpoint.restore(trainer, model_dir) == \
        ZOO_STEPS_K1 + ZOO_STEPS_K4
    return trainer


def _zoo_serve(name, trainer, export_path, cli_eval, launches):
    """14d: the eval of `--mode eval` equals a direct restore's on the
    CLI's first ZOO_EVALS batches; a ServingModel loaded from the export
    (made at the same step) predicts a batch as the trainer does. Returns
    the largest difference of the two predictions."""
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.serving.engine import ServingModel
    data = SyntheticCTR(batch_size=ZOO_B, seed=0)
    batches = [data.batch() for _ in range(ZOO_EVALS)]
    counted = Launches()
    ev = counted.run(lambda: trainer.evaluate(iter(batches)))
    for k in ("loss", "auc"):
        assert abs(cli_eval[k] - ev[k]) <= 1e-6 * abs(ev[k]), \
            (name, k, cli_eval, ev)
    model = ServingModel(trainer.task, export_path, unique_cap=ZOO_U,
                         device=trainer.device)
    fb, b = batches[0]
    want = counted.run(lambda: trainer.predict(fb, b)).cpu().numpy()
    got = counted.run(lambda: model.predict(fb, b))
    _expect_launches(counted.total, {"gather_rows": ZOO_EVALS + 1},
                     f"{name} eval and serve")
    launches.add(counted.total)
    assert got.shape == (ZOO_B,) and np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    return float(np.max(np.abs(got - want)))


def _zoo_window(name, trainer, launches):
    """ms/step (host clock, one synchronize at the end of each window),
    device busy ms/step and operations (kernels and copies) per step under
    torch.profiler, on the deepfm_f32 cell's stream (bench.py's
    SyntheticCTR(1,000,000 users, 200,000 items), seed 0), continuing the
    restored trainer; K1/K2 per step and bit for bit on the trained pool
    with the last step's rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.embedding.engine import EmbeddingEngine
    from monolith_tpu_torch.ops import scatter as ops
    from monolith_tpu_torch.profile_step import _device_intervals, _union_us
    data = SyntheticCTR(num_users=1_000_000, num_items=200_000,
                        batch_size=ZOO_B, seed=0)
    batches = [data.batch() for _ in range(ZOO_WARM + 2 * ZOO_WINDOW)]
    seen = {}
    real_lookup = EmbeddingEngine.fused_lookup

    def spy(self, states, inputs, seed, step):
        seen["states"], seen["inputs"] = states, inputs
        return real_lookup(self, states, inputs, seed, step)

    def steps(pairs):
        losses, uniques = [], []
        for fb, b in pairs:
            out = trainer.train_step(fb, b)
            losses.append(out["loss"])
            uniques.append(sum(out["stats"]["unique"].values()))
            assert not any(out["stats"]["overflow"].values()), out["stats"]
        torch.cuda.synchronize()
        return torch.stack(losses).cpu().numpy(), uniques

    counted = Launches()
    counted.run(lambda: steps(batches[:ZOO_WARM]))
    win = batches[ZOO_WARM:ZOO_WARM + ZOO_WINDOW]
    (losses, uniques), secs = _wall(lambda: counted.run(lambda: steps(win)))
    ms = secs / ZOO_WINDOW * 1e3
    EmbeddingEngine.fused_lookup = spy
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            counted.run(lambda: steps(batches[ZOO_WARM + ZOO_WINDOW:]))
    finally:
        EmbeddingEngine.fused_lookup = real_lookup
    n = ZOO_WARM + 2 * ZOO_WINDOW
    _expect_launches(counted.total, {"gather_rows": n, "scatter_rows": n},
                     f"{name} windows")
    launches.add(counted.total)
    assert np.isfinite(losses).all(), (name, losses)
    intervals = _device_intervals(prof)
    busy = _union_us(intervals) / 1e3 / ZOO_WINDOW
    ops_per_step = len(intervals) / ZOO_WINDOW
    # the kernels on this run's pool and rows, against their plain versions
    pool = seen["states"]["sparse"]["data"]
    rows = seen["inputs"]["sparse"]["rows"]
    out = ops.gather_rows(pool, rows)
    assert torch.equal(out, ops.gather_rows_plain(pool, rows)), name
    values = out + 1.0
    pool_k, pool_p = pool.clone(), pool.clone()
    ops.scatter_rows(pool_k, rows, values)
    ops.scatter_rows_plain(pool_p, rows, values)
    assert torch.equal(pool_k, pool_p), name
    del pool_k, pool_p, out, values
    return {"ms_per_step": ms, "busy_ms": busy, "idle": 1 - busy / ms,
            "ops_per_step": ops_per_step, "losses": losses,
            "uniques": int(np.mean(uniques)),
            "valid_rows": int((rows >= 0).sum())}


def _zoo_small(name, device):
    from monolith_tpu_torch import train
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig
    kw, _ = ZOO_SMALL[name]
    task, extra = ZOO[name]
    return Trainer(train.build_task(task, {**extra, **kw}), TrainerConfig(
        engine=EngineConfig(unique_cap=1024, new_cap=1024), log_every=0),
        device=device)


def _zoo_batch(name, pair):
    """MMoE's batches carry a second head's labels, as tests/test_models.py
    gives them."""
    fb, b = pair
    if name == "mmoe":
        b = dict(b, labels=np.stack([b["label"], 1.0 - b["label"]], axis=1))
    return fb, b


def _zoo_learns(name, device):
    """14b: tests/test_models.py's size and criterion, on the card: the
    mean loss of the last 10 of ZOO_LEARN_STEPS steps below that of the
    first 10; DIN's eval AUC above ZOO_DIN_AUC; MMoE's per-task losses in
    aux."""
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    _, seed = ZOO_SMALL[name]
    trainer = _zoo_small(name, device)
    size = (80, 40, 128) if name == "mmoe" else (100, 60, 256)
    data = SyntheticCTR(num_users=size[0], num_items=size[1],
                        batch_size=size[2], seed=seed)
    losses = []
    for _ in range(ZOO_LEARN_STEPS):
        out = trainer.train_step(*_zoo_batch(name, data.batch()))
        losses.append(out["loss"])
        if name == "mmoe":
            assert "loss_task0" in out["aux"], out["aux"]
    losses = np.array([float(v) for v in losses])
    assert np.isfinite(losses).all(), (name, losses)
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    assert last < first, (name, first, last)
    res = {"first10": first, "last10": last}
    if name in ("din", "dien"):
        ev = trainer.evaluate(iter(SyntheticCTR(
            num_users=100, num_items=60, batch_size=256, seed=seed)),
            max_steps=10)
        res["auc"] = ev["auc"]
        if name == "din":
            assert ev["auc"] > ZOO_DIN_AUC, (name, ev)
    return res


def _zoo_card_vs_cpu(name, device):
    """14c: one state, carried from a CPU trainer after 3 steps, trains 3
    more steps on the card and on the CPU on the same 3 batches again, whose
    ids both have admitted (new rows draw their init from the device's
    generator): losses to rtol 1e-4."""
    from monolith_tpu_torch import convert
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    _, seed = ZOO_SMALL[name]
    data = SyntheticCTR(num_users=100, num_items=60, batch_size=256,
                        seed=seed + 100)
    pairs = [_zoo_batch(name, data.batch()) for _ in range(3)]
    cpu = _zoo_small(name, "cpu")
    for i, p in enumerate(pairs):
        cpu.train_step(*p, ts=500 + i)
    card = _zoo_small(name, device)
    convert.load_state(card, convert.export_state(cpu))
    lc, lg = [], []
    for i, (fb, b) in enumerate(pairs):
        lc.append(cpu.train_step(fb, b, ts=600 + i)["loss"].item())
        out = card.train_step(fb, b, ts=600 + i)
        assert not any(out["stats"]["new"].values()), out["stats"]
        lg.append(out["loss"].item())
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    return lg, lc


def phase_zoo(device="cuda", device_args=()):
    """Phase 14 for each variant; returns the kernels' launches of the
    full-width runs (14a, 14d and the windows: path "zoo")."""
    import gc
    import shutil
    import tempfile

    import torch
    work = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    launches = Launches()
    try:
        t0 = time.time()
        for name in ZOO:
            model_dir, export_path, outs = _zoo_cli(name, work, launches,
                                                    device_args)
            trainer = _zoo_restored(name, model_dir, device)
            serve_err = _zoo_serve(name, trainer, export_path,
                                   outs[2][0]["eval"], launches)
            win = _zoo_window(name, trainer, launches)
            del trainer
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
            learned = _zoo_learns(name, device)
            lg, lc = _zoo_card_vs_cpu(name, device)
            train = [o["train"] for o, _ in outs[:2]]
            cli_ms = [ZOO_B / t["examples_per_sec"] * 1e3 for t in train]
            log(f"14 {name}: cli (a) {outs[0][1]:.3f} + {outs[1][1]:.3f} + "
                f"{outs[2][1]:.3f} s (train K=1, train K=4 + export, eval): "
                f"train loop {cli_ms[0]:.3f} / {cli_ms[1]:.3f} ms/step with "
                f"the data's generation, loss {train[0]['loss']:.5f} -> "
                f"{train[1]['loss']:.5f}, eval "
                f"{outs[2][0]['eval']} = a direct restore's; (d) served "
                f"predictions equal the trainer's (max abs diff "
                f"{serve_err:.3g}); window on the deepfm_f32 stream: "
                f"{win['ms_per_step']:.3f} ms/step, device busy "
                f"{win['busy_ms']:.4f} ms/step, idle {win['idle']:.4f}, "
                f"{win['ops_per_step']:.1f} device operations/step, K1 1 and "
                f"K2 1 a step, {win['uniques']} unique ids/step, "
                f"{win['valid_rows']} valid rows of the last gather (bit "
                f"for bit against the plain versions), losses "
                f"{np.round(win['losses'], 5).tolist()}; (b) {learned}; (c) "
                f"card {lg} vs cpu {lc}")
        log(f"phase 14: {time.time() - t0:.1f} s; zoo launches "
            f"{launches.total}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches.total


# ----------------------------------------------------------------------
# phase 15: the rest of the model library at the deepfm_f32 configuration
# ----------------------------------------------------------------------

#: the dense optimizers, each with the JAX package's defaults (Adagrad:
#: optax.adagrad(0.01), the task's default)
LIB_OPTIMIZERS = ("adagrad", "adamom", "adamom_v2", "rmsprop_v2", "shampoo")
LIB_FEATURES = ("user_id", "item_id", "hist_items")


def dense_optimizer(name):
    from monolith_tpu_torch import optimizers
    return getattr(optimizers, "Adagrad" if name == "adagrad" else name)()


def library_task(optimizer="adagrad", keep_prob=0.9, **deepfm_args):
    """DeepFMTask with phase 15's module in place of DeepFM's, as the JAX
    package's tests/test_infra.py subclasses a task with a BatchNorm
    module, and `optimizer` (a name of LIB_OPTIMIZERS) as its dense
    optimizer. The module: the pooled features concatenated (x); a cross
    branch DCN(layer_num=2, use_dropout=True, keep_prob) on x; a deep
    branch Dense(256, allow_kernel_norm=True) -> BatchNorm -> relu ->
    LHUCTower((128, 64)) gated by x -> LayerNorm; Dense(1) on both. Its
    flax twin is tests/test_torch_library.py's `JaxLibraryModule`."""
    import dataclasses

    import torch
    from torch import nn

    from monolith_tpu_torch import layers
    from monolith_tpu_torch.layers import initializers
    from monolith_tpu_torch.models.deepfm import DeepFMTask

    class LibraryModule(nn.Module):
        def __init__(self, width, generator=None):
            super().__init__()
            self.dcn = layers.DCN(width, layer_num=2, use_dropout=True,
                                  keep_prob=keep_prob, generator=generator)
            self.dense = layers.Dense(width, 256, allow_kernel_norm=True,
                                      generator=generator)
            self.bn = layers.BatchNorm(256)
            self.lhuc = layers.LHUCTower(256, (128, 64), lhuc_dim=width,
                                         generator=generator)
            self.ln = layers.LayerNorm(64)
            self.head = initializers.dense(width + 64, 1, generator)

        def forward(self, pooled, batch=None):
            x = torch.cat([pooled[f] for f in LIB_FEATURES], dim=1)
            h = torch.relu(self.bn(self.dense(x)))
            h = self.ln(self.lhuc(h, x))
            logits = self.head(torch.cat([self.dcn(x), h], dim=1))[:, 0]
            return {"logits": logits}

    @dataclasses.dataclass
    class LibraryTask(DeepFMTask):
        name: str = "library"

        def build_module(self, generator=None):
            return LibraryModule(len(LIB_FEATURES) * (1 + self.embedding_dim),
                                 generator)

        def dense_optimizer(self):
            return dense_optimizer(optimizer)

    return LibraryTask(**deepfm_args)


#: the deepfm_f32 cell: pool rows, unique_cap = new_cap, batch
LIB_CAP, LIB_U, LIB_B = 1 << 21, 32768, 8192
#: 15a: train steps one by one, then one block; the profiled window
LIB_STEPS, LIB_BLOCK, LIB_WINDOW = 8, 4, 4
#: 15b: the small size (card against CPU; zero init, no dropout)
LIB_SMALL = dict(embedding_dim=8, capacity_per_shard=8192, init_scale=0.0)
#: 15c: ranking lists [LTR_B, LTR_L]
LTR_B, LTR_L = 1024, 8


def _lib_trainer(optimizer, device, small=False, keep_prob=0.9):
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig
    if small:
        task = library_task(optimizer, keep_prob=keep_prob, **LIB_SMALL)
        engine = EngineConfig(unique_cap=1024, new_cap=1024)
    else:
        task = library_task(optimizer, keep_prob=keep_prob, embedding_dim=16,
                            capacity_per_shard=LIB_CAP)
        engine = EngineConfig(unique_cap=LIB_U, new_cap=LIB_U)
    return Trainer(task, TrainerConfig(engine=engine, log_every=0),
                   device=device)


def _flat_state(trainer):
    """The dense side, numpy by flax path: parameters, the optimizer's
    whole tree, model_state."""
    from monolith_tpu_torch import convert
    return {(tree,) + k: v for tree, t in (
        ("params", convert.dense_tree(trainer.module.named_parameters())),
        ("opt_state", trainer.tx.state_tree(trainer.opt_state)),
        ("model_state", trainer.model_state))
        for k, v in convert._flatten(t).items()}


def _assert_flat_equal(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def _lib_window(trainer, batches):
    """ms/step on the host clock over the first half of `batches` (one
    synchronize at the end), then device busy ms/step and device operations
    per step under torch.profiler over the second half."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from monolith_tpu_torch.profile_step import _device_intervals, _union_us
    n = len(batches) // 2
    t0 = time.perf_counter()
    for fb, b in batches[:n]:
        trainer.train_step(fb, b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fb, b in batches[n:]:
            trainer.train_step(fb, b)
        torch.cuda.synchronize()
    intervals = _device_intervals(prof)
    return (secs / n * 1e3, _union_us(intervals) / 1e3 / n,
            len(intervals) / n)


def _lib_full_width(optimizer, work, launches, device):
    """15a for one optimizer at the deepfm_f32 cell; returns its numbers.
    Every launch of the trainer's own path is counted (path "library")."""
    import torch

    from monolith_tpu_torch import convert
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.serving import ServingModel, export_model
    from monolith_tpu_torch.training import checkpoint
    data = SyntheticCTR(num_users=1_000_000, num_items=200_000,
                        batch_size=LIB_B, seed=0)
    batches = [data.batch() for _ in range(
        LIB_STEPS + LIB_BLOCK + 2 + 2 * LIB_WINDOW)]
    trainer = _lib_trainer(optimizer, device)
    counted = Launches()

    def steps(pairs):
        out = [trainer.train_step(fb, b)["loss"] for fb, b in pairs]
        return torch.stack(out).cpu().numpy()

    t0 = time.perf_counter()
    losses = counted.run(lambda: steps(batches[:LIB_STEPS]))
    first_s = time.perf_counter() - t0
    blk = batches[LIB_STEPS:LIB_STEPS + LIB_BLOCK]
    block = counted.run(lambda: trainer.train_step_block(blk))["loss"]
    losses = np.concatenate([losses, block.cpu().numpy()])
    assert np.isfinite(losses).all(), (optimizer, losses)
    mean = trainer.model_state["batch_stats"]["bn"]["mean"]
    assert np.abs(mean).sum() > 0, optimizer
    # eval mode: the running averages stay as they are, eval is repeatable
    before = _flat_state(trainer)
    fb, b = batches[LIB_STEPS + LIB_BLOCK]
    ev = counted.run(lambda: trainer.evaluate(iter([(fb, b)])))
    p1 = counted.run(lambda: trainer.predict(fb, b))
    p2 = counted.run(lambda: trainer.predict(fb, b))
    assert torch.equal(p1, p2), optimizer
    _assert_flat_equal(_flat_state(trainer), before, "evaluate")
    # checkpoint -> restore into a fresh trainer: everything bit for bit
    ckdir = os.path.join(work, optimizer, "ckpt")
    (path, save_s) = _wall(lambda: checkpoint.save(trainer, ckdir))
    fresh = _lib_trainer(optimizer, device)
    (_, restore_s) = _wall(lambda: checkpoint.restore(fresh, ckdir))
    _assert_flat_equal(_flat_state(fresh), before, "restore")
    for t, st in trainer.table_states.items():
        for k, v in st.items():
            assert torch.equal(fresh.table_states[t][k], v), (optimizer, t)
    nb = batches[LIB_STEPS + LIB_BLOCK + 1]
    oa = counted.run(lambda: trainer.train_step(*nb))
    ob = counted.run(lambda: fresh.train_step(*nb))
    assert torch.equal(oa["loss"], ob["loss"]), optimizer
    assert torch.equal(oa["preds"], ob["preds"]), optimizer
    del fresh
    # export -> ServingModel with the BatchNorm statistics
    export = counted.run(lambda: export_model(
        trainer, os.path.join(work, optimizer, "export")))
    model = ServingModel(trainer.task, export, unique_cap=LIB_U,
                         device=device)
    _assert_flat_equal(
        {k: v for k, v in convert._flatten(
            convert.model_state_tree(model.module)).items()},
        convert._flatten(trainer.model_state), "served statistics")
    want = counted.run(lambda: trainer.predict(fb, b)).cpu().numpy()
    got = counted.run(lambda: model.predict(fb, b))
    assert got.shape == (LIB_B,) and np.isfinite(got).all(), optimizer
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    del model
    win = batches[-2 * LIB_WINDOW:]
    ms, busy, ops = counted.run(lambda: _lib_window(trainer, win))
    # two train-mode forwards of one batch: the dropout draws differ by
    # step and repeat for the same step
    inputs, batch_t, _ = trainer._upload(fb, b, 0)
    with torch.no_grad():
        pooled, _ = counted.run(lambda: trainer.engine.embed(
            trainer.table_states, inputs, step=trainer.step))
        f1, f2, f3 = (trainer._forward(pooled, batch_t, s, training=True)[
            "logits"] for s in (100, 101, 100))
    assert not torch.equal(f1, f2) and torch.equal(f1, f3), optimizer
    n_steps = LIB_STEPS + LIB_BLOCK + 2 + 2 * LIB_WINDOW
    _expect_launches(counted.total, {
        # the steps; evaluate, 2 predicts, the export, 1 more predict, the
        # embed of the forwards
        "gather_rows": n_steps + 1 + 2 + 1 + 1 + 1,
        "scatter_rows": n_steps}, f"library {optimizer}")
    launches.add(counted.total)
    del trainer
    return {"losses": losses, "first_steps_s": first_s, "save_s": save_s,
            "restore_s": restore_s, "ms": ms, "busy": busy, "ops": ops,
            "auc": ev["auc"], "ckpt_bytes": _tree_bytes(path),
            "serve_err": float(np.max(np.abs(got - want)))}


def _lib_card_vs_cpu(optimizer, device):
    """15b: one state, carried from a CPU trainer after 3 steps, trains 3
    more steps on the card and on the CPU on the same batches (whose ids
    both have): losses and batch_stats to rtol 1e-4 (Shampoo 1e-3: the two
    eigh differ)."""
    from monolith_tpu_torch import convert
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    rtol = 1e-3 if optimizer == "shampoo" else 1e-4
    data = SyntheticCTR(num_users=100, num_items=60, batch_size=256,
                        seed=61)
    pairs = [data.batch() for _ in range(3)]
    cpu = _lib_trainer(optimizer, "cpu", small=True, keep_prob=1.0)
    for i, p in enumerate(pairs):
        cpu.train_step(*p, ts=500 + i)
    card = _lib_trainer(optimizer, device, small=True, keep_prob=1.0)
    convert.load_state(card, convert.export_state(cpu))
    lc, lg = [], []
    for i, (fb, b) in enumerate(pairs):
        lc.append(cpu.train_step(fb, b, ts=600 + i)["loss"].item())
        out = card.train_step(fb, b, ts=600 + i)
        assert not any(out["stats"]["new"].values()), out["stats"]
        lg.append(out["loss"].item())
    np.testing.assert_allclose(lg, lc, rtol=rtol)
    sc, sg = (convert._flatten(t.model_state) for t in (cpu, card))
    for k in sc:
        np.testing.assert_allclose(sg[k], sc[k], rtol=rtol, atol=1e-6,
                                   err_msg=f"{optimizer} {k}")
    return lg, lc


def _lib_dropout_on_card(device):
    """15b: dropout drawn on the card: the kept share of an [8192, 51] draw
    within 4 sigma of keep_prob, kept values exactly x / keep_prob."""
    import torch

    from monolith_tpu_torch.layers.draws import dropout
    keep = 0.9
    x = torch.randn(LIB_B, 51, device=device) + 3.0
    gen = torch.Generator(device=device).manual_seed(7)
    out = dropout(x, keep, gen)
    kept = out != 0
    share = kept.float().mean().item()
    sigma = float(np.sqrt(keep * (1 - keep) / x.numel()))
    assert abs(share - keep) < 4 * sigma, (share, sigma)
    assert torch.equal(out[kept], x[kept] / keep)
    return share, sigma


def _lib_losses_and_ops(device):
    """15c: the losses and ops at batch 8192 on the card and on the CPU
    from the same inputs: values and input gradients to rtol 1e-5, with an
    absolute slack of 1e-5 of each tensor's largest magnitude (sums over
    the batch that cancel). Returns each case's largest difference over
    that magnitude."""
    import torch

    from monolith_tpu_torch import losses, ops
    rng = np.random.default_rng(62)
    f32 = np.float32
    logits = rng.normal(size=LIB_B).astype(f32)
    labels = (rng.random(LIB_B) < 0.3).astype(f32)
    user, item = (rng.normal(size=(LIB_B, 16)).astype(f32) * 0.3
                  for _ in range(2))
    log_q = np.log(rng.random(LIB_B).astype(f32) + 0.01)
    rl = rng.integers(0, 4, (LTR_B, LTR_L)).astype(f32)
    rl[rng.random((LTR_B, LTR_L)) < 0.2] = -1.0   # invalid items
    rs = rng.normal(size=(LTR_B, LTR_L)).astype(f32)
    lw = (rng.random((LTR_B, 1)) + 0.5).astype(f32)
    emb = rng.normal(size=(LIB_B, 51)).astype(f32)
    w = rng.normal(size=(51, 8)).astype(f32) * 0.2
    counter = rng.integers(0, 12, LIB_B).astype(f32)
    keys = ["pairwise_hinge_loss", "pairwise_logistic_loss",
            "pairwise_soft_zero_one_loss", "softmax_loss",
            "sigmoid_cross_entropy_loss", "mean_squared_loss",
            "list_mle_loss", "approx_ndcg_loss"]
    ltr = losses.make_loss_fn(keys, [1.0 + 0.25 * i for i in range(8)],
                              {"approx_ndcg_loss": {"alpha": 5.0}})
    cases = {
        "inbatch_auc_loss": ((logits,), lambda lg: losses.inbatch_auc_loss(
            lg, torch.as_tensor(labels, device=lg.device))),
        "batch_softmax_loss": ((user, item), lambda u, i: losses.
                               batch_softmax_loss(u, i, torch.as_tensor(
                                   log_q, device=u.device), 0.5)),
        "make_loss_fn (8 keys)": ((rs,), lambda s: ltr(
            torch.as_tensor(rl, device=s.device), s,
            torch.as_tensor(lw, device=s.device))),
        "feature_insight": ((emb, w), lambda e, ww: ops.feature_insight(
            e, ww, (17, 17, 17))),
        "feature_insight aggregate": ((emb, w), lambda e, ww: ops.
                                      feature_insight(e, ww, (17, 17, 17),
                                                      aggregate=True)),
        "fid_counter": ((counter,), lambda c: ops.fid_counter(c, 10, 2.0)),
    }
    worst = {}
    for name, (inputs, fn) in cases.items():
        results = []
        for dev in (device, "cpu"):
            xs = [torch.tensor(a, device=dev, requires_grad=True)
                  for a in inputs]
            out = fn(*xs)
            proj = torch.as_tensor(
                np.random.default_rng(63).normal(size=out.shape).astype(f32),
                device=dev)
            grads = torch.autograd.grad(torch.sum(out * proj), xs)
            results.append([out.detach().cpu().numpy()]
                           + [g.cpu().numpy() for g in grads])
        err = 0.0
        for g, c in zip(*results):
            assert np.isfinite(g).all(), name
            # the weight gradients are sums over the batch's 8192 rows, some
            # cancelling to near zero: rounding is held against the
            # tensor's largest magnitude there, the other elements to rtol
            scale = float(np.abs(c).max())
            np.testing.assert_allclose(g, c, rtol=1e-5,
                                       atol=max(1e-6, 1e-5 * scale),
                                       err_msg=name)
            err = max(err, float(np.max(np.abs(g - c))) / max(scale, 1e-30))
        worst[name] = err
    return worst


def _compat_task(capacity):
    """tests/test_infra.py's compat task (compat.FeatureFactory: a user
    slot with a bias slice, an item slot shared by the history, a Dense
    head) at `capacity` rows a slot."""
    import torch

    from monolith_tpu_torch import compat
    from monolith_tpu_torch.layers import initializers
    from monolith_tpu_torch.training.task import RecTask
    fm = compat.FeatureFactory(default_capacity=capacity)
    fc_user = fm.create_embedding_feature_column(
        "user_id", occurrence_threshold=0, has_bias=True)
    fc_item = fm.create_embedding_feature_column("item_id")
    fc_hist = fm.create_embedding_feature_column(
        "hist_items", shared_name="item_id", combiner="reduce_mean",
        max_seq_length=10)
    u_vec = fc_user.feature_slot.add_feature_slice(8)
    u_bias = fc_user.feature_slot.get_bias_slice()
    i_vec = fc_item.feature_slot.add_feature_slice(8)
    tables, features = fm.build()

    class CompatModule(torch.nn.Module):
        def __init__(self, generator=None):
            super().__init__()
            self.head = initializers.dense(16, 1, generator)

        def forward(self, pooled, batch=None):
            uv = compat.lookup_embedding_slice(pooled, fc_user, u_vec)
            ub = fc_user.embedding_lookup(pooled, u_bias)[:, 0]
            iv = fc_item.embedding_lookup(pooled, i_vec)
            hv = fc_hist.embedding_lookup(pooled, i_vec)
            x = torch.cat([uv * iv, uv * hv], dim=-1)
            return {"logits": self.head(x)[:, 0] + ub}

    class CompatTask(RecTask):
        def tables(self):
            return tables

        def features(self):
            return features

        def build_module(self, generator=None):
            return CompatModule(generator)

    return CompatTask()


def _lib_compat(device):
    """15d: the compat task at capacity 2^21 and unique_cap 32768 trains 8
    steps on the deepfm_f32 stream; dump_model is JSON, dump_graph text.
    Returns (losses, launches, seconds of the graph dump, its length)."""
    import torch

    from monolith_tpu_torch import model_dump
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig
    trainer = Trainer(_compat_task(LIB_CAP), TrainerConfig(
        engine=EngineConfig(unique_cap=LIB_U, new_cap=LIB_U), log_every=0),
        device=device)
    data = SyntheticCTR(num_users=1_000_000, num_items=200_000,
                        batch_size=LIB_B, seed=0)
    batches = [data.batch() for _ in range(9)]
    counted = Launches()
    losses = counted.run(lambda: torch.stack([
        trainer.train_step(fb, b)["loss"] for fb, b in batches[:8]]
    ).cpu().numpy())
    assert np.isfinite(losses).all(), losses
    dump = json.loads(json.dumps(model_dump.dump_model(trainer),
                                 default=repr))
    assert dump["step"] == 8 and dump["dense_param_count"] == 17, dump
    assert sorted(dump["tables"]) == ["item_id", "user_id"], dump["tables"]
    text, graph_s = _wall(lambda: counted.run(
        lambda: model_dump.dump_graph(trainer, *batches[8])))
    assert isinstance(text, str) and "sigmoid" in text, text[:500]
    # two tables: a gather and a scatter each a step; the graph dump's
    # eval lookup gathers once a table
    _expect_launches(counted.total, {"gather_rows": 2 * 8 + 2,
                                     "scatter_rows": 2 * 8}, "compat")
    return losses, counted.total, graph_s, len(text)


def phase_library(device="cuda"):
    """Phase 15; returns the launches of 15a and 15d (path "library")."""
    import gc
    import shutil
    import tempfile

    import torch
    work = tempfile.mkdtemp(prefix="chip_smoke_library_")
    launches = Launches()
    t0 = time.time()
    try:
        for opt in LIB_OPTIMIZERS:
            r = _lib_full_width(opt, work, launches, device)
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
            log(f"15a {opt}: losses {np.round(r['losses'], 5).tolist()} "
                f"(8 steps, then a block of 4), finite; BatchNorm's running "
                f"mean off zero; evaluate left the dense state bit for bit "
                f"(auc {r['auc']:.5f}), two eval forwards equal, two "
                f"train-mode forwards differ; checkpoint ({r['ckpt_bytes']} "
                f"bytes) saved in {r['save_s']:.3f} s, restored in "
                f"{r['restore_s']:.3f} s: pool, parameters, optimizer tree "
                f"and model_state bit for bit, the next step of both equal "
                f"bit for bit; served = trainer.predict (max abs diff "
                f"{r['serve_err']:.3g}) with the statistics; "
                f"{r['ms']:.3f} ms/step, device busy {r['busy']:.4f} "
                f"ms/step, {r['ops']:.1f} device operations/step "
                f"(first 8 steps {r['first_steps_s']:.3f} s)")
        t1 = time.time()
        for opt in LIB_OPTIMIZERS:
            lg, lc = _lib_card_vs_cpu(opt, device)
            log(f"15b {opt}: card {lg} vs cpu {lc}")
        share, sigma = _lib_dropout_on_card(device)
        log(f"15b dropout on the card: kept share {share:.6f} (keep_prob "
            f"0.9, sigma {sigma:.6f}), kept values x / keep_prob exactly")
        t2 = time.time()
        worst = _lib_losses_and_ops(device)
        log(f"15c card vs cpu at batch {LIB_B} (values and input "
            f"gradients, rtol 1e-5, atol 1e-5 of the largest magnitude): "
            f"largest difference over the largest magnitude {worst}")
        t3 = time.time()
        losses, compat_launches, graph_s, graph_len = _lib_compat(device)
        launches.add(compat_launches)   # its pools are [2^21, 128] f32 too
        log(f"15d compat at capacity 2^21: losses "
            f"{np.round(losses, 5).tolist()}; dump_model JSON; dump_graph "
            f"{graph_len} characters in {graph_s:.3f} s; launches "
            f"{compat_launches}")
        log(f"phase 15: {time.time() - t0:.1f} s (15a {t1 - t0:.1f}, 15b "
            f"{t2 - t1:.1f}, 15c {t3 - t2:.1f}, 15d {time.time() - t3:.1f}); "
            f"library launches {launches.total}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches.total


# ----------------------------------------------------------------------
# phase 16: the sharded trainer on one NCCL rank
# ----------------------------------------------------------------------

SHARD_STEPS, SHARD_K, SHARD_WINDOW = 8, 8, 4
SHARD_RTOL = 1e-6        # 16a: the sharded trainer against the Trainer
# 16a's deepfm_f32 cell: pool rows, unique_cap = new_cap, batch
SHARD_CAP, SHARD_U, SHARD_B = 1 << 21, 32768, 8192
#: 16c's probe: the four collectives of the exchanges and the dense mean
GLOO_CUDA_PROBE = r"""
import json, sys, torch, torch.distributed as dist
port, rank = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=2)
x = torch.arange(8, dtype=torch.float32, device="cuda:0") + 10 * rank
calls = {
    "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
        torch.empty(16, device="cuda:0"), x),
    "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
        torch.empty(4, device="cuda:0"), x),
    "all_to_all_single": lambda: dist.all_to_all_single(
        torch.empty(8, device="cuda:0"), x),
    "all_reduce": lambda: dist.all_reduce(x.clone()),
}
out = {}
for name, call in calls.items():
    try:
        call()
        torch.cuda.synchronize()
        out[name] = "ok"
    except Exception as e:
        out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
dist.destroy_process_group()
print(json.dumps(out))
"""


def _world_of_one(device):
    """A world of one rank on an in-process store: NCCL on cuda:0 (gloo
    on the CPU, for a rehearsal)."""
    import torch.distributed as dist
    from monolith_tpu_torch.parallel import make_mesh
    backend = "nccl" if device == "cuda" else "gloo"
    dist.init_process_group(backend, rank=0, world_size=1,
                            store=dist.HashStore())
    mesh = make_mesh(device=None if device == "cuda" else device)
    assert mesh.backend == backend and mesh.device.type == device, mesh
    return mesh


def _gap(a, b):
    """max |a - b| over max |b|: a relative gap that zeros do not blow
    up."""
    a, b = a.detach().float(), b.detach().float()
    den = float(b.abs().max())
    return float((a - b).abs().max()) / (den or 1.0)


def _dense_gap(a, b):
    return max(_gap(p, q) for p, q in zip(a.module.parameters(),
                                          b.module.parameters()))


def _set_async(trainer, on):
    """Make the trainer's blocks 1-step-stale (or synchronous)."""
    import dataclasses
    cfg = trainer.config
    trainer.config = dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, async_optimize=on))


def _profiled_steps(trainer, batches, ts0):
    """Train steps under torch.profiler: (losses, device busy ms/step,
    device operations/step, the NCCL kernels' share of the busy time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from monolith_tpu_torch.profile_step import _union_us
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        losses = [trainer.train_step(fb, b, ts=ts0 + i)["loss"]
                  for i, (fb, b) in enumerate(batches)]
        torch.cuda.synchronize()
    spans, nccl = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            span = (e.time_range.start, e.time_range.end)
            spans.append(span)
            if "nccl" in e.name.lower():
                nccl.append(span)
    busy = _union_us(sorted(spans))
    share = _union_us(sorted(nccl)) / busy if busy else 0.0
    n = len(batches)
    return (torch.stack(losses).cpu().numpy(), busy / 1e3 / n,
            len(spans) / n, share)


def _hold_kernels_on(trainer, seen, rounding_seed=None):
    """K1 and K2 (and K3 when a seed is given) bit for bit against their
    plain versions on the trainer's pool and the last recorded step's
    rows; uncounted."""
    import torch
    from monolith_tpu_torch.ops import rounding
    from monolith_tpu_torch.ops import scatter as ops
    states, inputs = seen[-1]
    tname = sorted(inputs)[0]
    pool, rows = states[tname]["data"], inputs[tname]["rows"]
    out = ops.gather_rows(pool, rows)
    assert torch.equal(out, ops.gather_rows_plain(pool, rows)), "K1"
    values = out + 1
    pool_k, pool_p = pool.clone(), pool.clone()
    ops.scatter_rows(pool_k, rows, values)
    ops.scatter_rows_plain(pool_p, rows, values)
    assert torch.equal(pool_k, pool_p), "K2"
    if rounding_seed is not None:
        x = out.float()
        got = rounding.stochastic_round_bf16(x, rounding_seed)
        want = rounding.stochastic_round_bf16_plain(x, rounding_seed)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16)), \
            "K3"
    valid = int((rows >= 0).sum())
    del pool_k, pool_p, out, values
    return valid


def _record_lookups(trainer):
    """Record (states, inputs) at every fused_lookup of the trainer."""
    seen = []
    real = trainer.engine.fused_lookup

    def spy(states, inputs, seed, step):
        seen.append((states, inputs))
        return real(states, inputs, seed, step)
    trainer.engine.fused_lookup = spy
    return seen


class _Deterministic:
    """torch's deterministic algorithms for the block: index_add_ (the
    pooling's backward, the a2a's transpose) sums in a fixed order instead
    of by atomics, so that two trainers on the same batches stay equal
    beyond f32 rounding. Not for timing."""

    def __enter__(self):
        import torch
        torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        import torch
        torch.use_deterministic_algorithms(False)


def _sharded_deepfm(exchange, mesh, launches):
    """16a for one exchange: the sharded trainer beside the Trainer on the
    same batches, both at init_scale 0.0, first held equal (deterministic
    algorithms), then timed (the default ones); returns the numbers
    logged."""
    import torch
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.parallel import ShardedTrainer
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

    def task():
        return DeepFMTask(embedding_dim=16, capacity_per_shard=SHARD_CAP,
                          hidden=(256, 128, 64), init_scale=0.0)

    def config(**engine):
        return TrainerConfig(engine=EngineConfig(
            num_shards=1, unique_cap=SHARD_U, new_cap=SHARD_U, **engine),
            log_every=0)

    sharded = ShardedTrainer(task(), config(exchange=exchange), mesh)
    single = Trainer(task(), config(), device=mesh.device)
    data = SyntheticCTR(num_users=1_000_000, num_items=200_000,
                        batch_size=SHARD_B, seed=0)

    def take(n):
        return [data.batch() for _ in range(n)]
    steps, sync_block, async_block, evals = (
        take(SHARD_STEPS), take(SHARD_K), take(SHARD_K), take(1))
    timed, timed_block, window = (take(SHARD_STEPS), take(SHARD_K),
                                  take(SHARD_WINDOW))
    r = {}
    seen = _record_lookups(sharded)

    def gap():
        return max(_gap(sharded.table_states["sparse"]["data"],
                        single.table_states["sparse"]["data"]),
                   _dense_gap(sharded, single))

    def block(t, pairs, ts):
        t0 = time.perf_counter()
        out = t.train_step_block(pairs, ts=ts)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3 / len(pairs)

    with _Deterministic():
        # per-step: the sharded trainer counted, the Trainer not
        got, _ = _steps(sharded, steps, 0, launches)
        want, _ = _steps(single, steps, 0, Launches())
        np.testing.assert_allclose(got, want, rtol=SHARD_RTOL)
        r["steps_gap"] = gap()
        assert r["steps_gap"] <= SHARD_RTOL, r["steps_gap"]
        # a synchronous and an asynchronous block of K
        for pairs, on, ts in ((sync_block, False, SHARD_STEPS),
                              (async_block, True, SHARD_STEPS + 1)):
            for t in (sharded, single):
                _set_async(t, on)
            out, _ = launches.run(lambda: block(sharded, pairs, ts))
            ref, _ = block(single, pairs, ts)
            got = out["loss"].cpu().numpy()
            assert np.isfinite(got).all(), got
            np.testing.assert_allclose(got, ref["loss"].cpu().numpy(),
                                       rtol=SHARD_RTOL)
            assert tuple(out["preds"].shape) == (SHARD_K, SHARD_B)
            r["losses"] = got
        for t in (sharded, single):
            _set_async(t, False)
        r["blocks_gap"] = gap()
        assert r["blocks_gap"] <= SHARD_RTOL, r["blocks_gap"]
        r["eval"] = launches.run(lambda: sharded.evaluate(iter(evals)))
        ev = single.evaluate(iter(evals))
        assert abs(r["eval"]["loss"] - ev["loss"]) <= \
            SHARD_RTOL * ev["loss"], (r["eval"], ev)
        assert abs(r["eval"]["auc"] - ev["auc"]) <= SHARD_RTOL, (r["eval"], ev)
    # timed with the default algorithms: steps beside the Trainer's, a
    # block, then the window under the profiler
    _, r["ms"] = _steps(sharded, timed, 200, launches)
    _, r["single_ms"] = _steps(single, timed, 200, Launches())
    out, r["block_ms"] = launches.run(lambda: block(sharded, timed_block,
                                                    300))
    assert np.isfinite(out["loss"].cpu().numpy()).all()
    losses, r["busy"], r["ops"], r["nccl"] = launches.run(
        lambda: _profiled_steps(sharded, window, 400))
    assert np.isfinite(losses).all(), losses
    r["valid_rows"] = _hold_kernels_on(sharded, seen)
    del sharded, single, seen
    return r


def _sharded_multislot(mesh, launches):
    """16b: multislot_bf16 through the sharded trainer (allgather) beside
    the Trainer, 8 steps each; K1, K3, K2 per step."""
    import torch
    from monolith_tpu_torch.embedding.engine import _round_seed
    from monolith_tpu_torch.parallel import ShardedTrainer
    from monolith_tpu_torch.profile_step import CONFIGS
    from monolith_tpu_torch.training.trainer import Trainer
    single, data = CONFIGS["multislot_bf16"]()
    sharded = ShardedTrainer(single.task, single.config, mesh)
    batches = [data.batch() for _ in range(SHARD_STEPS)]
    seen = _record_lookups(sharded)
    got, ms = _steps(sharded, batches, 0, launches)
    want, single_ms = _steps(single, batches, 0, Launches())
    assert isinstance(single, Trainer) and np.isfinite(got).all(), got
    pools = [t.table_states["table_all"]["data"] for t in (sharded, single)]
    assert all(p.dtype == torch.bfloat16 for p in pools)
    # the rows the steps touched (the host stores are the same), by
    # distribution
    live = sharded.engine.shard_stores["table_all"][0].size()
    stats = []
    for p in pools:
        x = p[:live, :16].float()
        stats.append((float(x.mean()), float(x.std())))
    (m0, s0), (m1, s1) = stats
    assert abs(m0 - m1) <= 1e-2 * s1 and abs(s0 / s1 - 1) <= 1e-2, stats
    loss_gap = float(np.max(np.abs(np.asarray(got) - np.asarray(want))
                            / np.abs(want)))
    assert loss_gap <= 1e-2, (got, want)
    valid = _hold_kernels_on(sharded, seen,
                             rounding_seed=_round_seed(0, SHARD_STEPS - 1, 0))
    out = {"losses": got, "ms": ms, "single_ms": single_ms, "live": live,
           "stats": stats, "loss_gap": loss_gap, "valid_rows": valid,
           "pool_gap": _gap(pools[0], pools[1])}
    del sharded, single, seen, pools
    return out


def _gloo_cuda_probe():
    """16c's probe: two ranks on cuda:0 over gloo, each collective of the
    sharded step on CUDA tensors. Returns {collective: "ok" | error}."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO_CUDA_PROBE, str(port), str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            if p.returncode != 0:
                return {"process": f"exit {p.returncode}: "
                                   f"{err.strip().splitlines()[-1:]}"}
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {k: outs[0][k] if outs[0][k] != "ok" else outs[1][k]
            for k in outs[0]}


# 16c: two ranks sharing the card over gloo against two CPU ranks
SHARD2_CAP, SHARD2_STEPS, SHARD2_RTOL = 1 << 20, 8, 1e-5


def rank_16c(rank, port, device, out, packed="auto"):
    """One rank of 16c (run in a process of its own by `_run_16c`): the
    deepfm_f32 cell's a2a step over two gloo ranks, 8 steps from the
    seed's state (init_scale 0.0); writes the losses, ms/step, launches,
    dense params and the rank's shard of the table (params and slots, f32)
    by id into `out` (.npz). `packed="off"`: the structure-of-arrays state
    (18f)."""
    import torch
    import torch.distributed as dist
    from monolith_tpu_torch import ops
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.embedding import table as table_lib
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.parallel import ShardedTrainer, make_mesh
    from monolith_tpu_torch.training.trainer import TrainerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cpu":
        torch.set_num_threads(4)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    mesh = make_mesh(device=device)
    tr = ShardedTrainer(
        DeepFMTask(embedding_dim=16, capacity_per_shard=SHARD2_CAP,
                   hidden=(256, 128, 64), init_scale=0.0),
        TrainerConfig(engine=EngineConfig(num_shards=2, unique_cap=SHARD_U,
                                          new_cap=SHARD_U, exchange="a2a",
                                          packed=packed),
                      log_every=0), mesh)
    data = SyntheticCTR(num_users=1_000_000, num_items=200_000,
                        batch_size=SHARD_B, seed=0)
    batches = [data.batch() for _ in range(SHARD2_STEPS)]
    ops.reset_launch_counts()
    losses, times = [], []
    for i, (fb, b) in enumerate(batches):
        t0 = time.perf_counter()
        losses.append(float(tr.train_step(fb, b, ts=i)["loss"]))
        if device != "cpu":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = ops.launch_counts()
    fids, rows = tr.engine.shard_stores["sparse"][rank].save()[:2]
    order = np.argsort(fids)
    live = table_lib.full_rows(
        tr.engine.tables["sparse"], tr.table_states["sparse"],
        torch.from_numpy(rows[order]).to(tr.device))
    dense = {f"dense/{k}": p.detach().cpu().numpy()
             for k, p in tr.module.named_parameters()}
    np.savez(out, losses=np.asarray(losses), ms=np.asarray(times),
             fids=fids[order], live=live.cpu().numpy(),
             launches=np.asarray([counts["gather_rows"],
                                  counts["scatter_rows"]]), **dense)
    dist.destroy_process_group()


def _run_16c(device, packed="auto"):
    """Both ranks of 16c on `device` (cuda:0 shared, or the CPU); returns
    each rank's results."""
    import shutil
    import socket
    import tempfile
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    work = tempfile.mkdtemp(prefix="chip_smoke_16c_")
    outs = [os.path.join(work, f"rank{r}.npz") for r in range(2)]
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke as cs; cs.rank_16c("
         f"{r}, {port}, {device!r}, {outs[r]!r}, {packed!r})"], cwd=here,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        for r, p in enumerate(procs):
            log_text, _ = p.communicate(timeout=600)
            assert p.returncode == 0, (device, r, log_text[-4000:])
        return [dict(np.load(o)) for o in outs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)


def _hold_16c(card, cpu, device, launches):
    """Two ranks on the card against the same two on the CPU: losses,
    dense params and each shard's live rows by id within SHARD2_RTOL, K1
    and K2 launches a card rank as `launches`; returns the largest gap
    over the largest magnitude."""
    gaps = []
    for g, c in zip(card, cpu):
        np.testing.assert_allclose(g["losses"], c["losses"],
                                   rtol=SHARD2_RTOL)
        np.testing.assert_array_equal(g["fids"], c["fids"])
        for k in g:
            if k == "live" or k.startswith("dense/"):
                den = float(np.abs(c[k]).max()) or 1.0
                gaps.append(float(np.abs(g[k] - c[k]).max()) / den)
        if device != "cpu":
            assert g["launches"].tolist() == launches, g["launches"]
    assert max(gaps) <= SHARD2_RTOL, max(gaps)
    return max(gaps)


def phase_16c(device="cuda:0"):
    """16c: the a2a step over two gloo ranks sharing the card against the
    same ranks on the CPU (losses, dense params and each shard's live rows
    within SHARD2_RTOL); returns the card ranks' launches."""
    t0 = time.time()
    card = _run_16c(device)
    t1 = time.time()
    cpu = _run_16c("cpu")
    gap = _hold_16c(card, cpu, device, [SHARD2_STEPS] * 2)
    log(f"16c deepfm_f32 a2a, two gloo ranks sharing {device} (capacity "
        f"2^20 a shard), {SHARD2_STEPS} steps: losses "
        f"{np.round(card[0]['losses'], 5).tolist()} equal to two CPU "
        f"ranks' within {SHARD2_RTOL}; dense params and both shards' "
        f"{[len(c['fids']) for c in cpu]} live rows: largest gap over the "
        f"largest magnitude {gap:.3g}; ms/step on the card (median "
        f"of steps 3-8) {[round(float(np.median(g['ms'][2:])), 3) for g in card]}"
        f", on the CPU {[round(float(np.median(c['ms'][2:])), 3) for c in cpu]}"
        f"; K1/K2 a rank {card[0]['launches'].tolist()}; "
        f"{t1 - t0:.1f} s on the card, {time.time() - t1:.1f} s on the CPU")
    return {"gather_rows": int(sum(g["launches"][0] for g in card)),
            "scatter_rows": int(sum(g["launches"][1] for g in card)),
            "stochastic_round_bf16": 0}


def phase_sharded(device="cuda"):
    """Phase 16; returns the launches of 16a (path "sharded" of the
    deepfm_f32 kernels) and of 16b (of the multislot_bf16 ones)."""
    import gc

    import torch
    import torch.distributed as dist
    t0 = time.time()
    mesh = _world_of_one(device)
    deepfm = Launches()
    for exchange in ("allgather", "a2a"):
        r = _sharded_deepfm(exchange, mesh, deepfm)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"16a deepfm_f32 {exchange} (one {mesh.backend} rank, "
            f"{mesh.device}): losses "
            f"{np.round(r['losses'], 5).tolist()} (the asynchronous "
            f"block); with deterministic algorithms equal to the Trainer's "
            f"within {SHARD_RTOL} (losses; pools and dense params: largest "
            f"gap over the largest magnitude {r['steps_gap']:.3g} after 8 "
            f"steps, {r['blocks_gap']:.3g} after a synchronous and an "
            f"asynchronous block of 8; eval {r['eval']} equal); timed: "
            f"{r['ms']:.3f} ms/step (the Trainer {r['single_ms']:.3f}), a "
            f"block of 8 {r['block_ms']:.3f} ms/step; device busy "
            f"{r['busy']:.4f} "
            f"ms/step, {r['ops']:.1f} device operations/step, NCCL "
            f"{100 * r['nccl']:.2f}% of the busy time; K1/K2 bit for bit "
            f"on its pool ({r['valid_rows']} valid rows)")
    # per exchange: held 8 steps, 8 + 8 block steps (two K1 a step in the
    # asynchronous one), 1 eval batch; timed 8 steps, 8 block steps, 4
    want = {"gather_rows": 2 * (2 * SHARD_STEPS + 4 * SHARD_K + 1
                                + SHARD_WINDOW),
            "scatter_rows": 2 * (2 * SHARD_STEPS + 3 * SHARD_K
                                 + SHARD_WINDOW),
            "stochastic_round_bf16": 0}
    _expect_launches(deepfm.total, want, "16a")
    multislot = Launches()
    r = _sharded_multislot(mesh, multislot)
    _expect_launches(multislot.total, {"gather_rows": SHARD_STEPS,
                                       "scatter_rows": SHARD_STEPS,
                                       "stochastic_round_bf16": SHARD_STEPS},
                     "16b")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"16b multislot_bf16 allgather (one {mesh.backend} rank): losses "
        f"{np.round(r['losses'], 5).tolist()}, finite, within "
        f"{r['loss_gap']:.3g} of the Trainer's; bf16 pool, K3 bf16 and bit "
        f"for bit; {r['live']} live rows: mean / std of their params "
        f"{r['stats'][0]} vs the Trainer's {r['stats'][1]} (largest pool "
        f"gap {r['pool_gap']:.3g}); {r['ms']:.3f} ms/step (the Trainer "
        f"{r['single_ms']:.3f}); K1/K2/K3 bit for bit on its pool "
        f"({r['valid_rows']} valid rows)")
    dist.destroy_process_group()
    if device == "cuda":
        probe = _gloo_cuda_probe()
        log(f"16c probe, two gloo ranks on cuda:0: {json.dumps(probe)}")
        assert set(probe.values()) == {"ok"}, probe
    # the two card ranks' launches count with the path (their processes
    # count from 0 and end with the run)
    deepfm.add(phase_16c("cuda:0" if device == "cuda" else "cpu"))
    log(f"phase 16: {time.time() - t0:.1f} s; sharded launches "
        f"deepfm_f32 {deepfm.total}, multislot_bf16 {multislot.total}")
    return {"deepfm_f32": deepfm.total, "multislot_bf16": multislot.total}


# ----------------------------------------------------------------------
# phase 17: the multi-host trainer
# ----------------------------------------------------------------------

MH_RTOL, MH_ATOL = 1e-5, 1e-6   # 17a: the multi-host trainer vs the Trainer
MH_BF16_LOSS, MH_BF16_STATS = 1e-3, 1e-3   # 17b: losses, live-row stats
# 17c/17d: capacity a shard, steps, ttl, evict and spill points, tiered steps
MH2_CAP, MH2_STEPS, MH2_TTL = 1 << 20, 8, 8
MH2_EVICT, MH2_SPILL, MH2_TIERED, MH2_TIERED_TS = 2, 5, 4, 20
MH2_RTOL = 1e-5
#: the deepfm_f32 stream's users and items (bench.py's)
CTR_USERS, CTR_ITEMS = 1_000_000, 200_000


def _mh_task(cap, ttl=0):
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    return DeepFMTask(embedding_dim=16, capacity_per_shard=cap,
                      hidden=(256, 128, 64), init_scale=0.0, ttl_seconds=ttl)


def _mh_config(**engine):
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.training.trainer import TrainerConfig
    return TrainerConfig(engine=EngineConfig(
        **{"num_shards": 1, "unique_cap": SHARD_U, "new_cap": SHARD_U,
           **engine}), log_every=0)


def _rank_rows(pair, rank, world):
    """Rank `rank`'s rows of a global (fid_batch, batch)."""
    fb, b = pair
    n = len(next(iter(b.values()))) // world
    sl = slice(rank * n, (rank + 1) * n)
    return ({k: v[sl] for k, v in fb.items()},
            {k: v[sl] for k, v in b.items()})


def _own_rows_by_id(trainer):
    """(sorted fids, their packed rows read by K1's plain version) of the
    trainer's own shard."""
    import torch
    from monolith_tpu_torch.ops import scatter as ops
    fids, rows = trainer.engine.store_of("sparse").save()[:2]
    order = np.argsort(fids)
    pool = trainer.table_states["sparse"]["data"]
    idx = torch.from_numpy(np.ascontiguousarray(rows[order], np.int32))
    return fids[order], ops.gather_rows_plain(pool, idx.to(pool.device))


def _timed_block(trainer, pairs, ts):
    import torch
    t0 = time.perf_counter()
    out = trainer.train_step_block(pairs, ts=ts)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3 / len(pairs)


def _host_split(trainer, batches, ts0, launches):
    """Train steps (counted in `launches`) with the multi-host trainer's
    host phases timed: the local prepare, a2a#1, the owner map, the rest
    of the pack, and the upload (between two synchronizes). Returns ms a
    step of each."""
    import torch
    from monolith_tpu_torch.training import trainer as trainer_mod
    acc = {"prepare": 0.0, "a2a1": 0.0, "map": 0.0, "pack": 0.0,
           "upload": 0.0}

    def timed(fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            acc[key] += time.perf_counter() - t0
            return out
        return run

    names = {"_prepare_local": "prepare", "_send_ids": "a2a1",
             "_map_ids": "map", "_pack_full_wire": "pack"}
    for name, key in names.items():
        setattr(trainer, name, timed(getattr(trainer, name), key))
    real_upload = trainer_mod._PinnedWires.upload

    def upload(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_upload(self)
        torch.cuda.synchronize()
        acc["upload"] += time.perf_counter() - t0
        return out
    trainer_mod._PinnedWires.upload = upload
    try:
        _steps(trainer, batches, ts0, launches)
    finally:
        trainer_mod._PinnedWires.upload = real_upload
        for name in names:
            delattr(trainer, name)
    acc["pack"] -= acc["prepare"] + acc["a2a1"] + acc["map"]
    return {k: v * 1e3 / len(batches) for k, v in acc.items()}


def _mh_deepfm(mesh, launches):
    """17a: the deepfm_f32 cell (init_scale 0.0) through the multi-host
    trainer beside the Trainer on the same batches, first held equal
    (deterministic algorithms), then timed (the default ones) in turns
    with the Trainer and 16a's a2a ShardedTrainer; returns the numbers
    logged."""
    import torch
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.parallel import MultiHostTrainer, ShardedTrainer
    from monolith_tpu_torch.training.trainer import Trainer
    mh = MultiHostTrainer(_mh_task(SHARD_CAP), _mh_config(), mesh)
    single = Trainer(_mh_task(SHARD_CAP), _mh_config(), device=mesh.device)
    data = SyntheticCTR(num_users=CTR_USERS, num_items=CTR_ITEMS,
                        batch_size=SHARD_B, seed=0)

    def take(n):
        return [data.batch() for _ in range(n)]
    steps, sync_block, async_block, evals = (
        take(SHARD_STEPS), take(SHARD_K), take(SHARD_K), take(1))
    timed, split, sync_t, async_t, window = (
        take(SHARD_STEPS), take(SHARD_WINDOW), take(SHARD_K), take(SHARD_K),
        take(SHARD_WINDOW))
    r = {}
    seen = _record_lookups(mh)

    def gap():
        (fa, a), (fb, b) = _own_rows_by_id(mh), _own_rows_by_id(single)
        assert np.array_equal(fa, fb), "the two stores hold other ids"
        return max(_gap(a, b), _dense_gap(mh, single))

    with _Deterministic():
        got, _ = _steps(mh, steps, 0, launches)
        want, _ = _steps(single, steps, 0, Launches())
        np.testing.assert_allclose(got, want, rtol=MH_RTOL, atol=MH_ATOL)
        r["steps_gap"] = gap()
        assert r["steps_gap"] <= MH_RTOL, r["steps_gap"]
        for pairs, on, ts in ((sync_block, False, SHARD_STEPS),
                              (async_block, True, SHARD_STEPS + 1)):
            for t in (mh, single):
                _set_async(t, on)
            out, _ = launches.run(lambda: _timed_block(mh, pairs, ts))
            ref, _ = _timed_block(single, pairs, ts)
            got = out["loss"].cpu().numpy()
            np.testing.assert_allclose(got, ref["loss"].cpu().numpy(),
                                       rtol=MH_RTOL, atol=MH_ATOL)
            assert tuple(out["preds"].shape) == (SHARD_K, SHARD_B)
            r["losses"] = got
        for t in (mh, single):
            _set_async(t, False)
        r["blocks_gap"] = gap()
        assert r["blocks_gap"] <= MH_RTOL, r["blocks_gap"]
        r["eval"] = launches.run(lambda: mh.evaluate(iter(evals)))
        ev = single.evaluate(iter(evals))
        assert abs(r["eval"]["loss"] - ev["loss"]) <= \
            MH_RTOL * ev["loss"] + MH_ATOL, (r["eval"], ev)
        assert abs(r["eval"]["auc"] - ev["auc"]) <= MH_RTOL, (r["eval"], ev)
    # timed with the default algorithms, in turns on the same batches
    sharded = ShardedTrainer(_mh_task(SHARD_CAP), _mh_config(exchange="a2a"),
                             mesh)
    _, r["ms"] = _steps(mh, timed, 200, launches)
    _, r["single_ms"] = _steps(single, timed, 200, Launches())
    _, r["sharded_ms"] = _steps(sharded, timed, 200, Launches())
    del sharded
    torch.cuda.empty_cache()
    r["split"] = _host_split(mh, split, 300, launches)
    for key, pairs, on, ts in (("sync_ms", sync_t, False, 400),
                               ("async_ms", async_t, True, 500)):
        _set_async(mh, on)
        out, r[key] = launches.run(lambda: _timed_block(mh, pairs, ts))
        assert np.isfinite(out["loss"].cpu().numpy()).all()
    _set_async(mh, False)
    losses, r["busy"], r["ops"], r["nccl"] = launches.run(
        lambda: _profiled_steps(mh, window, 600))
    assert np.isfinite(losses).all(), losses
    r["idle"] = 1.0 - r["busy"] / r["ms"]
    r["valid_rows"] = _hold_kernels_on(mh, seen)
    del mh, single, seen
    return r


def _mh_multislot(mesh, launches):
    """17b: multislot_bf16 through the multi-host trainer, an asynchronous
    block of 8 beside the Trainer's; the all-to-alls of each step counted
    by dtype; K1/K2/K3 bit for bit on its pool."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from monolith_tpu_torch.embedding.engine import _round_seed
    from monolith_tpu_torch.parallel import MultiHostTrainer
    from monolith_tpu_torch.profile_step import CONFIGS
    single, data = CONFIGS["multislot_bf16"]()
    cfg = single.config
    mh = MultiHostTrainer(single.task, dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, async_optimize=True)),
        mesh)
    _set_async(single, True)
    batches = [data.batch() for _ in range(SHARD_K)]
    seen = _record_lookups(mh)
    calls, real = [], dist.all_to_all_single

    def spy(output, input, *a, **k):
        calls.append(str(input.dtype).replace("torch.", ""))
        return real(output, input, *a, **k)
    dist.all_to_all_single = spy
    try:
        out, ms = launches.run(lambda: _timed_block(mh, batches, 0))
    finally:
        dist.all_to_all_single = real
    ref, single_ms = _timed_block(single, batches, 0)
    # a step: a2a#1 of int32 ids (the block packs every step's first),
    # a2a#2 and a2a#3 of the one (bf16) wire dtype
    assert calls == ["int32"] * SHARD_K + ["bfloat16"] * 2 * SHARD_K, calls
    got, want = out["loss"].cpu().numpy(), ref["loss"].cpu().numpy()
    assert np.isfinite(got).all(), got
    loss_gap = float(np.max(np.abs(got - want) / np.abs(want)))
    assert loss_gap <= MH_BF16_LOSS, (got, want)
    pools = [t.table_states["table_all"]["data"] for t in (mh, single)]
    assert all(p.dtype == torch.bfloat16 for p in pools)
    live = mh.engine.store_of("table_all").size()
    stats = []
    for p in pools:
        x = p[:live, :16].float()
        stats.append((float(x.mean()), float(x.std())))
    (m0, s0), (m1, s1) = stats
    assert abs(m0 - m1) <= MH_BF16_STATS * s1 and \
        abs(s0 / s1 - 1) <= MH_BF16_STATS, stats
    valid = _hold_kernels_on(mh, seen,
                             rounding_seed=_round_seed(0, SHARD_K - 1, 0))
    r = {"losses": got, "ms": ms, "single_ms": single_ms, "live": live,
         "stats": stats, "loss_gap": loss_gap, "valid_rows": valid,
         "a2a_per_step": len(calls) / SHARD_K,
         "pool_gap": _gap(pools[0], pools[1])}
    del mh, single, seen, pools
    return r


def _rss_bytes():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


class _AckedPush(PushTo):
    """PushTo that keeps each push's ack (the rows the model applied)."""

    def __init__(self, model):
        super().__init__(model)
        self.acks = []

    def push(self, table, fids, values):
        self.acks.append(super().push(table, fids, values))
        return self.acks[-1]


def rank_17c(rank, port, device, work, out, sizes):
    """One rank of 17c/17d (a process of its own, `_run_17c`): the
    deepfm_f32 cell (capacity 2^20 a shard, init_scale 0.0, ttl 8, tiered,
    touches recorded) through MultiHostTrainer over two gloo ranks, each
    fed its half of every batch: 8 steps, a block of 8, an evaluation,
    expiry, a spill, 4 steps that revive, predict, export and checkpoint
    into `work`, a streaming round to phase 10c's stand-in target (a
    ServingModel of the two ranks' export). Writes the
    results, the launches and the rank's rows by id into `out` (.npz).
    `sizes`: the parent's (capacity a shard, unique_cap, global batch,
    users, items)."""
    import torch
    import torch.distributed as dist
    from monolith_tpu_torch import ops
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.embedding.host_store import HostStore
    from monolith_tpu_torch.embedding.tiered import state_width
    from monolith_tpu_torch.parallel import MultiHostTrainer, make_mesh
    from monolith_tpu_torch.serving.engine import ServingModel
    from monolith_tpu_torch.serving.export import export_model, latest_export
    from monolith_tpu_torch.training import checkpoint
    from monolith_tpu_torch.training.streaming import StreamingTrainer
    torch.backends.cuda.matmul.allow_tf32 = False
    card = device != "cpu"
    if not card:
        torch.set_num_threads(4)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    mesh = make_mesh(device=device)
    cap, unique, batch, users, items = sizes
    rss0 = _rss_bytes()
    probe = HostStore(row_capacity=cap)
    store_bytes = _rss_bytes() - rss0
    del probe
    tr = MultiHostTrainer(_mh_task(cap, ttl=MH2_TTL), _mh_config(
        num_shards=2, unique_cap=unique, new_cap=unique, tiered=True,
        record_touch=True), mesh)
    data = SyntheticCTR(num_users=users, num_items=items, batch_size=batch,
                        seed=0)
    glob = [data.batch() for _ in range(MH2_STEPS + SHARD_K + 1 + MH2_TIERED)]
    mine = [_rank_rows(p, rank, 2) for p in glob]
    steps, block = mine[:MH2_STEPS], mine[MH2_STEPS:MH2_STEPS + SHARD_K]
    ev = mine[MH2_STEPS + SHARD_K]
    tiered = mine[MH2_STEPS + SHARD_K + 1:]
    seen = _record_lookups(tr)
    archive = tr.engine.archive_of("sparse")

    def sync():
        if card:
            torch.cuda.synchronize()

    def step(pair, ts):
        t0 = time.perf_counter()
        loss = float(tr.train_step(*pair, ts=ts)["loss"])
        sync()
        return loss, (time.perf_counter() - t0) * 1e3

    sync()
    ops.reset_launch_counts()
    res = {}
    res["losses"], res["ms"] = map(np.asarray, zip(
        *[step(p, i) for i, p in enumerate(steps)]))
    res["block"] = tr.train_step_block(block, ts=MH2_STEPS)["loss"].cpu()
    e = tr.evaluate(iter([ev]))
    res["eval"] = np.asarray([e["loss"], e["auc"]])
    res["freed"] = tr.evict_expired(MH2_EVICT)["sparse"]
    res["spilled"] = tr.spill_expired(MH2_SPILL)["sparse"]
    revived, tl, tms = [], [], []
    for i, p in enumerate(tiered):
        before = archive.revived
        loss, ms = step(p, MH2_TIERED_TS + i)
        tl.append(loss)
        tms.append(ms)
        revived.append(archive.revived - before)
    res["tiered_losses"], res["tiered_ms"] = np.asarray(tl), np.asarray(tms)
    res["revived"] = np.asarray(revived)
    res["width"] = state_width(tr.engine.tables["sparse"])
    res["predict"] = tr.predict(*ev).cpu().numpy()
    export_model(tr, os.path.join(work, "export"))
    checkpoint.save(tr, os.path.join(work, "ckpt"))
    # phase 10c's stand-in target: the pushes land in a ServingModel of
    # the two ranks' export
    model = ServingModel(_mh_task(cap), latest_export(
        os.path.join(work, "export")), unique_cap=unique, device=device)
    target = _AckedPush(model)
    pushed = StreamingTrainer(tr, target).sync_now().get("sparse", 0)
    sync()
    counts = ops.launch_counts()
    res["launches"] = np.asarray([counts["gather_rows"],
                                  counts["scatter_rows"]])
    fids, live = _own_rows_by_id(tr)
    width = res["width"]
    dim = tr.engine.tables["sparse"].dim
    (_, pf), = target.pushes
    order = np.searchsorted(fids, pf)
    assert np.array_equal(fids[order], pf)
    res["pushed"], res["acked"] = pushed, target.acks[0]
    res["push_ok"] = np.asarray(np.array_equal(
        model.lookup_rows("sparse", pf), live[torch.from_numpy(order).to(
            live.device), :dim].float().cpu().numpy()))
    res["valid_rows"] = _hold_kernels_on(tr, seen)
    res["fids"], res["live"] = fids, live[:, :width].float().cpu().numpy()
    for k, p in tr.module.named_parameters():
        res[f"dense/{k}"] = p.detach().cpu().numpy()
    res["store_bytes"], res["rss"] = store_bytes, _rss_bytes()
    res["held"] = np.asarray([s is not None
                              for s in tr.engine.shard_stores["sparse"]])
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
    dist.barrier()
    dist.destroy_process_group()


def _run_17c(device, work):
    """Both ranks of 17c on `device` (cuda:0 shared, or the CPU); returns
    each rank's results."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.makedirs(work)
    outs = [os.path.join(work, f"rank{r}.npz") for r in range(2)]
    here = os.path.dirname(os.path.abspath(__file__))
    sizes = (MH2_CAP, SHARD_U, SHARD_B, CTR_USERS, CTR_ITEMS)
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke as cs; cs.rank_17c("
         f"{r}, {port}, {device!r}, {work!r}, {outs[r]!r}, {sizes!r})"],
        cwd=here,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        for r, p in enumerate(procs):
            log_text, _ = p.communicate(timeout=600)
            assert p.returncode == 0, (device, r, log_text[-4000:])
        return [dict(np.load(o)) for o in outs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def phase_17c(device, work):
    """17c/17d: the two-rank run on the card (`device`) and on the CPU,
    held equal within MH2_RTOL; returns the card ranks' results."""
    t0 = time.time()
    card = _run_17c(device, os.path.join(work, "card"))
    t1 = time.time()
    cpu = _run_17c("cpu", os.path.join(work, "cpu"))
    gaps = []
    for r, (g, c) in enumerate(zip(card, cpu)):
        assert g["held"].tolist() == [s == r for s in range(2)], g["held"]
        for k in ("losses", "block", "eval", "tiered_losses", "predict"):
            np.testing.assert_allclose(g[k], c[k], rtol=MH2_RTOL,
                                       err_msg=f"rank {r} {k}")
        for k in ("freed", "spilled", "revived", "fids", "pushed"):
            np.testing.assert_array_equal(g[k], c[k], err_msg=f"rank {r} {k}")
        for k in g:
            if k == "live" or k.startswith("dense/"):
                den = float(np.abs(c[k]).max()) or 1.0
                gaps.append(float(np.abs(g[k] - c[k]).max()) / den)
        assert bool(g["push_ok"]) and int(g["pushed"]) > 0, r
        assert int(g["acked"]) == int(g["pushed"]), r
        if device != "cpu":
            # steps, block, tiered steps (K1 + K2 each), eval, predict,
            # export and the streaming round (K1 each), the spill (K1 + the
            # zeroing K2), the eviction's zeroing K2
            spill, freed = int(g["spilled"] > 0), int(len(g["freed"]) > 0)
            train = MH2_STEPS + SHARD_K + MH2_TIERED
            assert g["launches"].tolist() == [train + 4 + spill,
                                              train + spill + freed], \
                g["launches"]
    assert max(gaps) <= MH2_RTOL, max(gaps)
    assert sum(int(g["revived"].sum()) for g in card) > 0, "nothing revived"
    return card, t1 - t0, time.time() - t1, max(gaps)


def _mh_restored(card, work, mesh):
    """17c's files in one process: the two ranks' checkpoint restored into
    a one-rank multi-host trainer (2 -> 1) and into the Trainer, each
    equal by id to the ranks' rows; their export served by one
    ServingModel, which answers as the ranks' predict did."""
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.parallel import MultiHostTrainer
    from monolith_tpu_torch.serving.engine import ServingModel
    from monolith_tpu_torch.serving.export import latest_export
    from monolith_tpu_torch.training import checkpoint
    from monolith_tpu_torch.training.trainer import Trainer
    fids = np.concatenate([g["fids"] for g in card])
    order = np.argsort(fids)
    fids = fids[order]
    live = np.concatenate([g["live"] for g in card])[order]
    width = int(card[0]["width"])
    ckpt = os.path.join(work, "card", "ckpt")
    out = {}
    for name, make in (
            ("multihost", lambda: MultiHostTrainer(
                _mh_task(MH2_CAP, MH2_TTL), _mh_config(tiered=True), mesh)),
            ("trainer", lambda: Trainer(
                _mh_task(MH2_CAP, MH2_TTL), _mh_config(tiered=True),
                device=mesh.device))):
        t = make()
        t0 = time.perf_counter()
        checkpoint.restore(t, ckpt)
        out[f"{name}_s"] = time.perf_counter() - t0
        got_fids, got = _own_rows_by_id(t)
        np.testing.assert_array_equal(got_fids, fids)
        np.testing.assert_array_equal(got[:, :width].float().cpu().numpy(),
                                      live, err_msg=name)
        del t
    model = ServingModel(_mh_task(MH2_CAP), latest_export(
        os.path.join(work, "card", "export")), unique_cap=SHARD_U,
        device=mesh.device)
    data = SyntheticCTR(num_users=CTR_USERS, num_items=CTR_ITEMS,
                        batch_size=SHARD_B, seed=0)
    for _ in range(MH2_STEPS + SHARD_K):
        data.batch()
    ev = data.batch()
    pred = model.predict(*ev)
    np.testing.assert_allclose(pred, card[0]["predict"], rtol=1e-4,
                               atol=1e-6)
    out["rows"] = len(fids)
    return out


def phase_multihost(device="cuda"):
    """Phase 17; returns the launches of 17a and 17c's card ranks (path
    "multihost" of the deepfm_f32 kernels) and of 17b (of the
    multislot_bf16 ones)."""
    import gc
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    t0 = time.time()
    work = tempfile.mkdtemp(prefix="chip_smoke_17_")
    try:
        card_dev = "cuda:0" if device == "cuda" else "cpu"
        card, card_s, cpu_s, gap = phase_17c(card_dev, work)
        mesh = _world_of_one(device)
        deepfm, multislot = Launches(), Launches()
        r = _mh_deepfm(mesh, deepfm)
        gc.collect()
        torch.cuda.empty_cache()
        _expect_launches(deepfm.total, {
            "gather_rows": 2 * SHARD_STEPS + 6 * SHARD_K + 1
            + 2 * SHARD_WINDOW,
            "scatter_rows": 2 * SHARD_STEPS + 4 * SHARD_K
            + 2 * SHARD_WINDOW}, "17a")
        sp = r["split"]
        log(f"17a deepfm_f32 (one {mesh.backend} rank, {mesh.device}): "
            f"losses {np.round(r['losses'], 5).tolist()} (the asynchronous "
            f"block); with deterministic algorithms equal to the Trainer's "
            f"within rtol {MH_RTOL} / atol {MH_ATOL} (losses; pools by id "
            f"and dense params: largest gap over the largest magnitude "
            f"{r['steps_gap']:.3g} after 8 steps, {r['blocks_gap']:.3g} after "
            f"a synchronous and an asynchronous block of 8; eval "
            f"{r['eval']}); timed in turns: {r['ms']:.3f} ms/step (the "
            f"Trainer {r['single_ms']:.3f}, 16a's a2a ShardedTrainer "
            f"{r['sharded_ms']:.3f}); host a step: local prepare "
            f"{sp['prepare']:.3f} ms, a2a#1 {sp['a2a1']:.3f}, owner map "
            f"{sp['map']:.3f}, pack {sp['pack']:.3f}, upload "
            f"{sp['upload']:.3f}; a block of 8: synchronous "
            f"{r['sync_ms']:.3f} ms/step, asynchronous {r['async_ms']:.3f}; "
            f"device busy {r['busy']:.4f} ms/step, {r['ops']:.1f} device "
            f"operations/step, idle {100 * r['idle']:.1f}%, NCCL "
            f"{100 * r['nccl']:.2f}% of the busy time; K1/K2 bit for bit on "
            f"its pool ({r['valid_rows']} valid rows)")
        b = _mh_multislot(mesh, multislot)
        _expect_launches(multislot.total, {
            "gather_rows": 2 * SHARD_K, "scatter_rows": SHARD_K,
            "stochastic_round_bf16": SHARD_K}, "17b")
        gc.collect()
        torch.cuda.empty_cache()
        log(f"17b multislot_bf16 asynchronous block of 8 (one "
            f"{mesh.backend} rank): losses "
            f"{np.round(b['losses'], 5).tolist()}, within {b['loss_gap']:.3g} "
            f"of the Trainer's; {b['a2a_per_step']:.0f} all_to_all_single a "
            f"step (int32 ids, bf16 rows, bf16 gradients); {b['live']} live "
            f"rows: mean / std of their params {b['stats'][0]} vs the "
            f"Trainer's {b['stats'][1]} (largest pool gap "
            f"{b['pool_gap']:.3g}); {b['ms']:.3f} ms/step (the Trainer "
            f"{b['single_ms']:.3f}); K1/K2/K3 bit for bit on its pool "
            f"({b['valid_rows']} valid rows)")
        restored = _mh_restored(card, work, mesh)
        dist.destroy_process_group()
        live = [len(g["fids"]) for g in card]
        log(f"17c deepfm_f32 over two gloo ranks sharing {card_dev} (capacity "
            f"2^20 a shard, tiered, ttl {MH2_TTL}): 8 steps, a block of 8, "
            f"an evaluation {card[0]['eval'].tolist()}, expiry (freed "
            f"{[len(g['freed']) for g in card]}), the spill, 4 steps, "
            f"predict: equal to two CPU ranks' within {MH2_RTOL} (largest "
            f"gap of dense params and rows by id {gap:.3g}); ms/step on the "
            f"card (median of steps 3-8) "
            f"{[round(float(np.median(g['ms'][2:])), 3) for g in card]}; "
            f"each rank holds its own store: live rows {live}, one host "
            f"store of capacity 2^20 {card[0]['store_bytes']} B a rank "
            f"(a ShardedTrainer rank holds both: {sum(live)} rows, "
            f"{2 * int(card[0]['store_bytes'])} B); rank RSS "
            f"{[int(g['rss']) for g in card]} B; the ranks' checkpoint "
            f"restored 2 -> 1 into a one-rank MultiHostTrainer "
            f"({restored['multihost_s']:.3f} s) and into the Trainer "
            f"({restored['trainer_s']:.3f} s), {restored['rows']} rows equal "
            f"by id; their export served by one ServingModel = their "
            f"predict (rtol 1e-4); a streaming round pushed "
            f"{[int(g['pushed']) for g in card]} rows into a ServingModel "
            f"of the export, all acked, each equal to its pool row; K1/K2 a "
            f"rank "
            f"{[g['launches'].tolist() for g in card]}, bit for bit on its "
            f"pool; {card_s:.1f} s on the card, {cpu_s:.1f} s on the CPU")
        width = int(card[0]["width"])
        before = [round(float(np.median(g['ms'][2:])), 3) for g in card]
        log(f"17d tiered per shard: spilled "
            f"{[int(g['spilled']) for g in card]} rows, revived a step "
            f"{[g['revived'].tolist() for g in card]} "
            f"({[int(g['revived'].sum()) * width * 4 for g in card]} B of "
            f"archived state in all), tiered ms/step "
            f"{[round(float(np.median(g['tiered_ms'])), 3) for g in card]} "
            f"against {before} before the spill")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    deepfm.add({"gather_rows": int(sum(g["launches"][0] for g in card)),
                "scatter_rows": int(sum(g["launches"][1] for g in card)),
                "stochastic_round_bf16": 0})
    log(f"phase 17: {time.time() - t0:.1f} s; multihost launches deepfm_f32 "
        f"{deepfm.total}, multislot_bf16 {multislot.total}")
    return {"deepfm_f32": deepfm.total, "multislot_bf16": multislot.total}


# ----------------------------------------------------------------------
# phase 18: the multi-array step and the structure-of-arrays state
# ----------------------------------------------------------------------

SOA_STEPS, SOA_WINDOW = 8, 4   # 18a-18c train steps; 18a's profiled ones
MA_B = 32768                   # 18c's batch
SOA_RTOL = 1e-5                # 18d: losses and f32 tables, card vs CPU
SOA_RAGGED = [(13, 17)]        # K3's ragged case (n % 4 != 0)
NO_KERNELS = {"gather_rows": 0, "scatter_rows": 0,
              "stochastic_round_bf16": 0}


def _state_bytes(state):
    """Bytes of a table state's tensors (either layout)."""
    from monolith_tpu_torch.embedding import table as table_lib
    sizes = []
    table_lib.map_state(lambda a: sizes.append(a.numel() * a.element_size()),
                        state)
    return sum(sizes)


def _turns(runs, batches, ts0):
    """The same batches through several trainers, in turns at each step;
    runs = [(trainer, Launches)]. Returns per trainer (losses, median ms a
    step over steps 3.., host clock with a synchronize)."""
    import torch
    out = [([], []) for _ in runs]
    for i, (fb, b) in enumerate(batches):
        for (tr, counter), (losses, times) in zip(runs, out):
            def one(tr=tr, times=times):
                t0 = time.perf_counter()
                o = tr.train_step(fb, b, ts=ts0 + i)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                return o
            o = counter.run(one)
            losses.append(o["loss"].item())
            assert not any(o["stats"]["overflow"].values()), o["stats"]
    res = []
    for losses, times in out:
        assert np.isfinite(losses).all(), losses
        res.append((np.asarray(losses), float(np.median(times[2:]))))
    return res


def phase_soa_multislot(work, soa):
    """18a: multislot_bf16 as structure of arrays at full width, 8 steps
    in turns with the packed trainer, 4 under the profiler; checkpoint
    into both layouts; export and serve."""
    import torch
    from monolith_tpu_torch.embedding import table as table_lib
    from monolith_tpu_torch.profile_step import CONFIGS
    from monolith_tpu_torch.serving import ServingModel, export_model
    from monolith_tpu_torch.training import checkpoint
    trainer, data = CONFIGS["multislot_bf16"](packed="off")
    packed, _ = CONFIGS["multislot_bf16"]()
    spec = trainer.engine.tables["table_all"]
    st = trainer.table_states["table_all"]
    assert not trainer.engine.packed and not trainer.engine.fuse_wire
    assert st["params"].dtype == torch.bfloat16 and \
        tuple(st["params"].shape) == (MS_CAP, spec.dim), st["params"].shape
    assert all(a.dtype == torch.float32 for seg in st["slots"]
               for a in seg.values())
    r = {"soa_bytes": _state_bytes(st),
         "packed_bytes": _state_bytes(packed.table_states["table_all"])}
    batches = [data.batch() for _ in range(SOA_STEPS + SOA_WINDOW + 2)]
    counted = Launches()
    (r["losses"], r["ms"]), (r["packed_losses"], r["packed_ms"]) = _turns(
        [(trainer, counted), (packed, Launches())], batches[:SOA_STEPS], 0)
    _expect_launches(counted.total, dict(NO_KERNELS, stochastic_round_bf16=
                                         SOA_STEPS), "18a steps")
    del packed
    torch.cuda.empty_cache()
    window = batches[SOA_STEPS:SOA_STEPS + SOA_WINDOW]
    losses, r["busy"], r["ops"], _ = counted.run(
        lambda: _profiled_steps(trainer, window, SOA_STEPS))
    assert np.isfinite(losses).all(), losses
    soa.add(counted.total)
    # checkpoint -> a structure-of-arrays trainer and a packed one
    hw = int(trainer.engine.stores["table_all"].save()[1].max()) + 1
    t0 = time.perf_counter()
    checkpoint.save(trainer, os.path.join(work, "ckpt"))
    r["save_s"] = time.perf_counter() - t0
    into = {}
    for layout, kw in (("soa", {"packed": "off"}), ("packed", {})):
        fresh, _ = CONFIGS["multislot_bf16"](**kw)
        checkpoint.restore(fresh, os.path.join(work, "ckpt"))
        into[layout] = fresh.table_states["table_all"]
        del fresh
    own = table_lib.params_view(spec, st)[:hw]
    for layout, other in into.items():
        assert torch.equal(table_lib.params_view(spec, other)[:hw].view(
            torch.int16), own.view(torch.int16)), f"18a params into {layout}"
    for i, seg in enumerate(st["slots"]):
        for name, arr in seg.items():
            assert torch.equal(into["soa"]["slots"][i][name][:hw], arr[:hw])
            # the packed pool holds the f32 slot rounded to nearest bf16
            got = table_lib.slot_view(spec, into["packed"], i, name)[:hw]
            assert torch.equal(got.view(torch.int16), arr[:hw].to(
                torch.bfloat16).view(torch.int16)), f"18a slot {name}"
    r["rows"] = hw
    del into
    torch.cuda.empty_cache()
    # export -> ServingModel on the card = the trainer's predict
    counted = Launches()
    path = counted.run(lambda: export_model(trainer, os.path.join(work,
                                                                  "export")))
    model = ServingModel(trainer.task, path, unique_cap=MS_U)
    r["serve_gap"] = 0.0
    for fb, b in batches[-2:]:
        preds = model.predict(fb, b)
        want = counted.run(lambda: trainer.predict(fb, b)).cpu().numpy()
        assert preds.shape == want.shape and np.isfinite(preds).all()
        np.testing.assert_allclose(preds, want, rtol=1e-3, atol=1e-5)
        r["serve_gap"] = max(r["serve_gap"], float(
            np.max(np.abs(preds - want) / np.maximum(np.abs(want), 1e-6))))
    _expect_launches(counted.total, NO_KERNELS, "18a export and predict")
    soa.add(counted.total)
    del model, trainer
    return r


def phase_multi_array_deepfm(ma):
    """18b: deepfm_f32 without the compact wire (int32 index matrices on
    the multi-array path) beside the wire Trainer on the same batches,
    deterministic algorithms: losses, pools and dense params bit for
    bit."""
    import torch
    from monolith_tpu_torch.profile_step import CONFIGS
    multi, data = CONFIGS["deepfm"](compact_wire=False)
    wire, _ = CONFIGS["deepfm"]()
    assert not multi.engine.fuse_wire and multi.engine.packed
    assert wire.engine.fuse_wire
    batches = [data.batch() for _ in range(SOA_STEPS)]
    wire_count = Launches()
    with _Deterministic():
        (ml, m_ms), (wl, w_ms) = _turns(
            [(multi, ma), (wire, wire_count)], batches, 0)
    assert np.array_equal(ml, wl), (ml, wl)
    assert torch.equal(multi.table_states["sparse"]["data"],
                       wire.table_states["sparse"]["data"]), "18b pools"
    assert all(torch.equal(p, q) for p, q in zip(
        multi.module.parameters(), wire.module.parameters())), "18b dense"
    want = dict(NO_KERNELS, gather_rows=SOA_STEPS, scatter_rows=SOA_STEPS)
    _expect_launches(ma.total, want, "18b multi-array")
    _expect_launches(wire_count.total, want, "18b wire")
    layout = multi._batch_layout(batches[0][1])
    r = {"losses": ml, "ms": m_ms, "wire_ms": w_ms,
         "bytes": 4 * multi._full_wire_words(layout),
         "wire_bytes": 4 * wire._full_wire_words(layout)}
    del multi, wire
    return r


def phase_multi_array_big(ma):
    """18c: multislot_bf16 packed at batch 32768, unique_cap = new_cap from
    suggest_caps over the first 3 batches (int32 path): 8 steps, at least
    one mapping more than 65535 unique ids; returns the numbers and the
    kernel cases at these shapes (the pool, the last step's rows and
    values; K3's input, those rows gathered as f32)."""
    import torch
    from monolith_tpu_torch.ops import scatter as ops
    from monolith_tpu_torch.profile_step import CONFIGS
    from monolith_tpu_torch.utils.tuning import suggest_caps
    probe, data = CONFIGS["multislot_bf16"](batch_size=MA_B)
    feats = {t: [f.name for f in fs]
             for t, fs in probe.engine.table_features.items() if fs}
    del probe
    torch.cuda.empty_cache()
    first = [data.batch() for _ in range(3)]
    cap = suggest_caps([fb for fb, _ in first], feats,
                       compact_wire_limit=None)["table_all"]
    trainer, _ = CONFIGS["multislot_bf16"](batch_size=MA_B, unique_cap=cap)
    assert trainer.engine.packed and not trainer.engine.fuse_wire
    batches = first + [data.batch() for _ in range(SOA_STEPS - 3)]
    uniques, host = [], []
    prepare = trainer.engine.prepare_batch

    def timed(fid_batch, ts):
        t0 = time.perf_counter()
        inputs, stats = prepare(fid_batch, ts)
        host.append((time.perf_counter() - t0) * 1e3)
        uniques.append(stats["unique"]["table_all"])
        return inputs, stats
    trainer.engine.prepare_batch = timed
    seen = _record_lookups(trainer)
    losses, ms = _steps(trainer, batches, 0, ma)
    assert max(uniques) > 65535, uniques
    _expect_launches(ma.total, {"gather_rows": SOA_STEPS,
                                "scatter_rows": SOA_STEPS,
                                "stochastic_round_bf16": SOA_STEPS}, "18c")
    layout = trainer._batch_layout(batches[0][1])
    states, inputs = seen[-1]
    pool, rows = states["table_all"]["data"], inputs["table_all"]["rows"]
    gathered = ops.gather_rows(pool, rows)
    r = {"cap": cap, "uniques": uniques, "losses": losses, "ms": ms,
         "host_ms": float(np.median(host[2:])),
         "bytes": 4 * trainer._full_wire_words(layout)}
    case = (pool, rows.clone(), gathered + 1)
    x = gathered.float()
    del trainer, seen, states, inputs, gathered
    return r, case, x


def _soa_small(kind, device):
    """18d's small trainers, structure of arrays, init_scale 0.0: the
    multislot bf16 variant (stochastic rounding, f32 tower) or DeepFM
    f32."""
    import torch
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.models.multislot import MultiSlotTask
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig
    if kind == "multislot":
        task = MultiSlotTask(num_tables=4, num_slots=10, embedding_dim=8,
                             capacity_per_shard=8192, history_length=6,
                             hidden=(32,), merge=True, init_scale=0.0,
                             table_dtype=torch.bfloat16,
                             stochastic_rounding=True)
        cap = 2048
    else:
        task = DeepFMTask(capacity_per_shard=4096, hidden=(32, 16),
                          init_scale=0.0)
        cap = 512
    return Trainer(task, TrainerConfig(engine=EngineConfig(
        unique_cap=cap, new_cap=cap, packed="off"), log_every=0),
        device=device)


def phase_soa_card_vs_cpu():
    """18d: each small structure-of-arrays trainer on the card and on the
    CPU from one carried state, 3 steps on the same batches: losses and
    f32 tables within SOA_RTOL, bf16 params within one bf16 ulp. Returns
    {kind: (largest loss gap, largest table gap)}."""
    import torch
    from monolith_tpu_torch import convert
    from monolith_tpu_torch.data.synthetic import (SyntheticCTR,
                                                   SyntheticMultiSlot)
    out = {}
    for kind in ("multislot", "deepfm"):
        data = (SyntheticMultiSlot(num_slots=10, vocab_per_slot=300,
                                   history_length=6, batch_size=256, seed=11)
                if kind == "multislot" else
                SyntheticCTR(num_users=400, num_items=300, batch_size=64,
                             seed=11))
        batches = [data.batch() for _ in range(6)]
        cpu = _soa_small(kind, "cpu")
        for i in range(3):
            cpu.train_step(*batches[i], ts=500 + i)
        card = _soa_small(kind, "cuda")
        convert.load_state(card, convert.export_state(cpu))
        lc, lg = [], []
        with _Deterministic():
            for i in range(3, 6):
                lc.append(cpu.train_step(*batches[i], ts=500 + i)["loss"]
                          .item())
                lg.append(card.train_step(*batches[i], ts=500 + i)["loss"]
                          .item())
        np.testing.assert_allclose(lg, lc, rtol=SOA_RTOL)
        table_gap = 0.0
        for t, sc in cpu.table_states.items():
            sg = card.table_states[t]
            a, b = sg["params"].cpu(), sc["params"]
            if b.dtype == torch.bfloat16:
                # one ulp of bf16: 2^-7 of the value's power of two
                big = torch.maximum(a.float().abs(), b.float().abs())
                ulp = torch.exp2(torch.floor(torch.log2(
                    big.clamp(min=1e-30))) - 7)
                assert bool(((a.float() - b.float()).abs() <= ulp).all()), \
                    f"18d {kind} bf16 params beyond one ulp"
            else:
                table_gap = max(table_gap, _gap(a, b))
            for i, seg in enumerate(sc["slots"]):
                for name, arr in seg.items():
                    table_gap = max(table_gap, _gap(
                        sg["slots"][i][name].cpu(), arr))
        assert table_gap <= SOA_RTOL, (kind, table_gap)
        out[kind] = (float(np.max(np.abs(np.array(lg) / np.array(lc) - 1))),
                     table_gap)
        del cpu, card
    return out


def phase_soa_tiered(soa):
    """18e: deepfm_f32 tiered as structure of arrays (ttl 8): 16 steps,
    spill_expired(8): the freed rows read zero in params and every slot;
    2 steps whose user ids were spilled: each revived row's params and
    slots, as admit_rows left them for the forward, equal the archived
    values bit for bit; 2 more steps."""
    import torch
    from monolith_tpu_torch.embedding import table as table_lib
    from monolith_tpu_torch.profile_step import CONFIGS
    trainer, data = CONFIGS["deepfm"](ttl_seconds=EXPIRY_TTL, tiered=True,
                                      packed="off")
    spec = trainer.engine.tables["sparse"]
    _steps(trainer, [data.batch() for _ in range(EXPIRY_STEPS)], 0, soa)
    store, archive = (trainer.engine.stores["sparse"],
                      trainer.engine.archives["sparse"])
    fids, rows, tss, _ = store.save()
    old = tss < EXPIRE_BEFORE
    t0 = time.perf_counter()
    spilled = soa.run(lambda: trainer.spill_expired(EXPIRE_BEFORE))
    spill_s = time.perf_counter() - t0
    assert spilled["sparse"] == int(old.sum()) == archive.size(), spilled
    freed = table_lib.full_rows(spec, trainer.table_states["sparse"],
                                torch.from_numpy(rows[old]).cuda())
    assert not freed.any(), "18e spilled rows not zero"
    a_fids, a_rows, _, _ = archive.map.save()
    archived = {f: archive.values[r].copy()
                for f, r in zip(a_fids.tolist(), a_rows.tolist())}
    users = a_fids[(a_fids >> 54) == 1]
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(2):
        fb, b = data.batch()
        batches.append((dict(fb, user_id=rng.choice(
            users, (len(b["label"]), 1), replace=False)), b))
    checked = []
    real = trainer.engine.lookup_unique

    def spy(states, inputs):
        tin = inputs["sparse"]
        rr = tin.get("revive_rows")
        if rr is None:          # no revived row this step
            checked.append(0)
            return real(states, inputs)
        n = int((rr >= 0).sum())
        got = table_lib.full_rows(spec, states["sparse"], rr[:n]).cpu()
        assert torch.equal(got.view(torch.int32),
                           tin["revive_values"][:n].cpu().view(torch.int32))
        probe = np.array(list(archived), np.int64)
        fid_of_row = dict(zip(store.lookup(probe).tolist(), probe.tolist()))
        for row, v in zip(rr[:n].cpu().tolist(), got.numpy()):
            assert np.array_equal(v.view(np.int32),
                                  archived[fid_of_row[row]].view(np.int32))
        checked.append(n)
        return real(states, inputs)
    trainer.engine.lookup_unique = spy
    losses, _ = _steps(trainer, batches, EXPIRY_STEPS, soa)
    trainer.engine.lookup_unique = real
    assert checked[0] >= len(batches[0][1]["label"]), checked
    more, ms = _steps(trainer, [data.batch() for _ in range(2)],
                      EXPIRY_STEPS + 2, soa)
    _expect_launches(soa.total, NO_KERNELS, "18e")
    r = {"spilled": spilled["sparse"], "spill_s": spill_s,
         "revived": checked, "losses": losses + more, "ms": ms}
    del trainer
    return r


def phase_soa_sharded(soa):
    """18f: the sharded trainer on the structure-of-arrays state: one NCCL
    rank (a world of one) against the structure-of-arrays Trainer at
    deepfm_f32 width, 8 steps under deterministic algorithms, bit for bit
    (losses, params, slots, dense); then 16c's two gloo ranks sharing
    cuda:0 against two CPU ranks, structure of arrays."""
    import torch
    import torch.distributed as dist
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.parallel import ShardedTrainer
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

    def task():
        return DeepFMTask(embedding_dim=16, capacity_per_shard=SHARD_CAP,
                          hidden=(256, 128, 64), init_scale=0.0)

    config = TrainerConfig(engine=EngineConfig(
        unique_cap=SHARD_U, new_cap=SHARD_U, packed="off"), log_every=0)
    mesh = _world_of_one("cuda")
    r = {"backend": mesh.backend}
    try:
        sharded = ShardedTrainer(task(), config, mesh)
        single = Trainer(task(), config, device=mesh.device)
        data = SyntheticCTR(num_users=1_000_000, num_items=200_000,
                            batch_size=SHARD_B, seed=0)
        batches = [data.batch() for _ in range(SHARD_STEPS)]
        with _Deterministic():
            got, r["ms"] = _steps(sharded, batches, 0, soa)
            want, r["single_ms"] = _steps(single, batches, 0, Launches())
        assert got == want, (got, want)
        a, b = sharded.table_states["sparse"], single.table_states["sparse"]
        assert torch.equal(a["params"], b["params"]), "18f params"
        assert all(torch.equal(a["slots"][i][n], b["slots"][i][n])
                   for i, seg in enumerate(b["slots"]) for n in seg)
        assert all(torch.equal(p, q) for p, q in zip(
            sharded.module.parameters(), single.module.parameters()))
        r["losses"] = got
        del sharded, single
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    t0 = time.time()
    card = _run_16c("cuda:0", packed="off")
    t1 = time.time()
    cpu = _run_16c("cpu", packed="off")
    r["gloo_gap"] = _hold_16c(card, cpu, "cuda:0", [0, 0])
    r["gloo_losses"] = card[0]["losses"]
    r["gloo_ms"] = [float(np.median(g["ms"][2:])) for g in card]
    r["gloo_s"] = (t1 - t0, time.time() - t1)
    _expect_launches(soa.total, NO_KERNELS, "18f")
    return r


def phase_soa(floor):
    """Phase 18. Returns (the new kernel entries: K3 on 18a's [49152, 17]
    params and a ragged length, K1/K2/K3 at 18c's shapes; the launches of
    the driven runs by path and config {"soa" | "multi_array": {config:
    counts}}; the profiler cases {"multi_array": (pool, rows, values)} and
    the K3 inputs {path: x})."""
    import shutil
    import tempfile

    import torch
    t0 = time.time()
    work = tempfile.mkdtemp(prefix="chip_smoke_18_")
    soa = {"deepfm_f32": Launches(), "multislot_bf16": Launches()}
    ma = {"deepfm_f32": Launches(), "multislot_bf16": Launches()}
    try:
        a = phase_soa_multislot(work, soa["multislot_bf16"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"18a multislot_bf16 structure of arrays (params [{MS_CAP}, 17] "
        f"bf16, Adagrad slots f32): {a['soa_bytes']} bytes of table state "
        f"against the packed pool's {a['packed_bytes']}; {SOA_STEPS} steps "
        f"in turns with the packed trainer on the same batches: losses "
        f"{np.round(a['losses'], 5).tolist()} (packed "
        f"{np.round(a['packed_losses'], 5).tolist()}), ms/step "
        f"{a['ms']:.3f} (packed {a['packed_ms']:.3f}; median of steps 3-8, "
        f"host clock with synchronize); under torch.profiler over "
        f"{SOA_WINDOW} steps: device busy {a['busy']:.4f} ms/step, "
        f"{a['ops']:.1f} device operations/step; K3 one launch a step, K1 "
        f"and K2 none; checkpoint ({a['rows']} live rows, save "
        f"{a['save_s']:.3f} s) restored into a structure-of-arrays trainer "
        f"(params and slots bit for bit) and a packed one (params bit for "
        f"bit, slots = the f32 slots rounded to nearest bf16); export served "
        f"by a ServingModel on the card = the trainer's predict (largest "
        f"relative gap {a['serve_gap']:.3g}, rtol 1e-3: bf16 tower, as "
        f"phase 10b's multislot)")
    b = phase_multi_array_deepfm(ma["deepfm_f32"])
    torch.cuda.empty_cache()
    log(f"18b deepfm_f32 multi-array (compact_wire=False: int32 index "
        f"matrices, {b['bytes']} bytes uploaded a step against the wire's "
        f"{b['wire_bytes']}): {SOA_STEPS} steps beside the wire Trainer, "
        f"deterministic algorithms: losses "
        f"{np.round(b['losses'], 5).tolist()}, losses, pools and dense "
        f"params bit for bit; K1 and K2 one launch a step each on both "
        f"paths; ms/step {b['ms']:.3f} (wire {b['wire_ms']:.3f}; with "
        f"deterministic algorithms)")
    c, ma_case, ma_x = phase_multi_array_big(ma["multislot_bf16"])
    log(f"18c multislot_bf16 packed at batch {MA_B}: unique_cap = new_cap = "
        f"{c['cap']} (suggest_caps over the first 3 batches, int32 path); "
        f"unique ids a step {c['uniques']} (more than 65535 on "
        f"{sum(u > 65535 for u in c['uniques'])} of {SOA_STEPS}); losses "
        f"{np.round(c['losses'], 5).tolist()}; ms/step {c['ms']:.3f} "
        f"(median, synchronized); host prepare_batch {c['host_ms']:.3f} ms "
        f"a step (median of steps 3-8); upload {c['bytes']} bytes a step in "
        f"one copy; K1, K2, K3 one launch a step each")
    d = phase_soa_card_vs_cpu()
    torch.cuda.empty_cache()
    log(f"18d card vs cpu, structure of arrays, 3 carried steps: "
        + "; ".join(f"{k}: losses' largest relative gap {lg:.3g}, tables "
                    f"{tg:.3g}" for k, (lg, tg) in d.items())
        + f" (losses and f32 tables within {SOA_RTOL}, bf16 params within "
          f"one bf16 ulp)")
    e = phase_soa_tiered(soa["deepfm_f32"])
    torch.cuda.empty_cache()
    log(f"18e deepfm_f32 tiered structure of arrays (ttl {EXPIRY_TTL}): "
        f"spill_expired({EXPIRE_BEFORE}) spilled {e['spilled']} rows in "
        f"{e['spill_s']:.3f} s, their params and slots read zero; revived "
        f"rows a step {e['revived']}, each equal to its archived params "
        f"and slots bit for bit as the forward reads them; losses "
        f"{np.round(e['losses'], 5).tolist()}; ms/step {e['ms']:.3f}; no "
        f"kernel launched")
    f = phase_soa_sharded(soa["deepfm_f32"])
    torch.cuda.empty_cache()
    log(f"18f sharded structure of arrays: one {f['backend']} rank = the "
        f"structure-of-arrays Trainer bit for bit over {SHARD_STEPS} steps "
        f"(losses {np.round(f['losses'], 5).tolist()}, params, slots, "
        f"dense; deterministic algorithms; ms/step {f['ms']:.3f} vs "
        f"{f['single_ms']:.3f}); two gloo ranks sharing cuda:0 = two CPU "
        f"ranks within {SHARD2_RTOL} (largest gap {f['gloo_gap']:.3g}; "
        f"losses {np.round(f['gloo_losses'], 5).tolist()}; ms/step "
        f"{np.round(f['gloo_ms'], 3).tolist()}; {f['gloo_s'][0]:.1f} s on "
        f"the card, {f['gloo_s'][1]:.1f} s on the CPU)")
    # the kernels at the new shapes against their plain versions
    g = torch.Generator(device="cuda").manual_seed(3)
    soa_x = torch.randn((MS_U, 17), generator=g, device="cuda")
    kernels = phase_rounding("soa", floor, x=soa_x, ragged=SOA_RAGGED)
    kernels += phase_rows("multi_array", floor, case=ma_case)
    kernels += phase_rounding("multi_array", floor, x=ma_x)
    launches = {"soa": {k: v.total for k, v in soa.items()},
                "multi_array": {k: v.total for k, v in ma.items()}}
    for k in kernels:
        if k["path"] == "soa":
            k["launches_by_path"] = {"soa": launches["soa"][
                "multislot_bf16"][k["name"]]}
        else:
            k["launches_by_path"] = {"multi_array": launches["multi_array"][
                "multislot_bf16"][k["name"]]}
        k["launches"] = sum(k["launches_by_path"].values())
    log(f"phase 18: {time.time() - t0:.1f} s; launches {launches}")
    return kernels, launches, {"multi_array": ma_case}, {"soa": soa_x,
                                                         "multi_array": ma_x}


# ----------------------------------------------------------------------
# phase 19: tiered storage and deltas on the sharded trainer, and the
# ranks that parallel.launch starts
# ----------------------------------------------------------------------

# 19a/19b: capacity a shard, steps, ttl (ts = step), spill point, revive
# steps, the block that revives; 19b's tolerance against the CPU ranks
ST_CAP, ST2_CAP = 1 << 21, 1 << 20
ST_STEPS, ST_TTL, ST_SPILL, ST_REVIVE, ST_K = 16, 8, 8, 2, 4
ST2_RTOL = 1e-5
#: 19c's run of train.main's rank body: steps, eval batches
CLI19_STEPS, CLI19_EVAL = 6, 2


def _st_sizes(cap):
    """The deepfm_f32 cell's sizes for phase 19 (passed to its rank
    processes, so that a rehearsal that shrinks them shrinks those too)."""
    return {"cap": cap, "U": SHARD_U, "B": SHARD_B, "users": CTR_USERS,
            "items": CTR_ITEMS}


def _st_task(sz):
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    return DeepFMTask(embedding_dim=16, capacity_per_shard=sz["cap"],
                      hidden=(256, 128, 64), init_scale=0.0,
                      ttl_seconds=ST_TTL)


def _st_config(sz, num_shards=1, **engine):
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.training.trainer import TrainerConfig
    engine.setdefault("tiered", True)
    return TrainerConfig(engine=EngineConfig(
        num_shards=num_shards, unique_cap=sz["U"], new_cap=sz["U"],
        **engine), log_every=0)


def _st_data(sz):
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    return SyntheticCTR(num_users=sz["users"], num_items=sz["items"],
                        batch_size=sz["B"], seed=0)


def _archived(archive):
    """{fid: archived row} of an archive."""
    fids, rows, _, _ = archive.map.save()
    return {f: archive.values[r].copy()
            for f, r in zip(fids.tolist(), rows.tolist())}


def _revive_batches(data, users, n, seed):
    """n batches of the stream whose user_id column holds the given
    (spilled) user ids."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        fb, b = data.batch()
        out.append((dict(fb, user_id=rng.choice(
            users, (len(b["label"]), 1), replace=False)), b))
    return out


def _rows_of(trainer, rows):
    """Packed rows of the trainer's own pool, read by K1's plain version."""
    import torch
    from monolith_tpu_torch.ops import scatter as ops
    return ops.gather_rows_plain(
        trainer.table_states["sparse"]["data"],
        torch.from_numpy(np.ascontiguousarray(rows, np.int32)).to(
            trainer.device)).cpu().numpy()


def _check_handed(trainer, seen, archived, width):
    """Every revived row that fused_lookup handed the model (records of
    `_spy_lookup`) is its archived state bit for bit, the columns after it
    zero. Returns the revived rows a step."""
    fids, rows = trainer.engine.store_of("sparse").save()[:2]
    fid_of_row = dict(zip(rows.tolist(), fids.tolist()))
    counts = []
    for prows, inputs in seen:
        tin = inputs["sparse"]
        pos = tin.get("revive_pos")
        pos = (pos[pos >= 0].long() if pos is not None
               else pos)
        counts.append(0 if pos is None else len(pos))
        if not counts[-1]:
            continue
        handed = prows["sparse"][pos].cpu().numpy()
        for r, h in zip(tin["rows"][pos].cpu().tolist(), handed):
            want = archived[fid_of_row[r]]
            assert np.array_equal(h[:width].view(np.int32),
                                  want.view(np.int32)), r
            assert not h[width:].any(), r
    return counts


def _st_sequence(trainer, data, launches):
    """19a/19b's sequence on a tiered sharded trainer (every rank of a
    group calls it): ST_STEPS steps at ts = step, spill_expired(ST_SPILL),
    ST_REVIVE steps whose user ids were spilled, a synchronous block of
    ST_K that revives; every revived row handed to the model checked
    against its archived state. Returns the numbers and the batches."""
    from monolith_tpu_torch.embedding.tiered import state_width
    width = state_width(trainer.engine.tables["sparse"])
    archive = trainer.engine.archive_of("sparse")
    r = {"batches": [data.batch() for _ in range(ST_STEPS)]}
    r["losses"], r["ms"] = _steps(trainer, r["batches"], 0, launches)
    # the expiring rows of the trainer's own shard, by K1's plain version
    fids, rows, tss, _ = trainer.engine.store_of("sparse").save()
    old = tss < ST_SPILL
    want = dict(zip(fids[old].tolist(), _rows_of(trainer, rows[old])[:, :width]))
    # every shard's expiring user ids: the same on every rank
    users = []
    for st in trainer.engine.shard_stores["sparse"]:
        f, _, t, _ = st.save()
        users.append(f[(t < ST_SPILL) & ((f >> 54) == 1)])
    users = np.sort(np.concatenate(users))
    t0 = time.perf_counter()
    r["spilled"] = launches.run(lambda: trainer.spill_expired(ST_SPILL))
    _sync()
    r["spill_s"] = time.perf_counter() - t0
    a_fids, a_rows, _, _ = archive.map.save()
    assert len(a_fids) == int(old.sum()), (len(a_fids), int(old.sum()))
    for f, v in zip(a_fids.tolist(), archive.values[a_rows]):
        assert np.array_equal(v.view(np.int32), want[f].view(np.int32)), f
    assert not _rows_of(trainer, rows[old]).any(), "spilled rows not zero"
    r["archive_entries"] = len(a_fids)
    # steps whose user ids were spilled: they revive
    r["revive_batches"] = _revive_batches(data, users, ST_REVIVE, 5)
    archived = _archived(archive)
    seen, real = _spy_lookup(trainer)
    before = archive.revived
    r["revive_losses"], r["revive_ms"] = _steps(
        trainer, r["revive_batches"], ST_STEPS, launches)
    r["revived"] = _check_handed(trainer, seen, archived, width)
    assert archive.revived - before == sum(r["revived"]) > 0, (
        archive.revived, before, r["revived"])
    # a synchronous block of ST_K that revives spilled user ids the steps
    # did not (the same on every rank)
    archived = _archived(archive)
    taken = np.concatenate([fb["user_id"].ravel()
                            for fb, _ in r["revive_batches"]])
    r["block_batches"] = _revive_batches(data, np.setdiff1d(users, taken),
                                         ST_K, 6)
    seen.clear()
    before = archive.revived
    t0 = time.perf_counter()
    out = launches.run(lambda: trainer.train_step_block(
        r["block_batches"], ts=ST_STEPS + ST_REVIVE))
    _sync()
    r["block_ms"] = (time.perf_counter() - t0) * 1e3 / ST_K
    trainer.engine.fused_lookup = real
    r["block_losses"] = out["loss"].cpu().numpy()
    assert np.isfinite(r["block_losses"]).all(), r["block_losses"]
    r["block_revived"] = _check_handed(trainer, seen, archived, width)
    assert archive.revived - before == sum(r["block_revived"]) > 0
    r["seen"] = [(trainer.table_states, seen[-1][1])]
    return r


def _delta_round(trainer, fresh, work, since_ts, launches):
    """save_delta(since_ts) from `trainer` (every rank), restore_delta into
    `fresh` (as many ranks): the fresh pool's rows equal the delta's values
    and the trainer's rows by id, bit for bit. Returns the numbers."""
    from monolith_tpu_torch.training import checkpoint
    r = {}
    t0 = time.perf_counter()
    path = launches.run(lambda: checkpoint.save_delta(trainer, work,
                                                      since_ts=since_ts))
    r["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    applied = launches.run(lambda: checkpoint.restore_delta(fresh, path))
    _sync()
    r["restore_s"] = time.perf_counter() - t0
    r["bytes"] = _tree_bytes(path)
    own = trainer.engine.shard
    z = np.load(os.path.join(path, f"sparse-s{own}.npz"))
    dim = trainer.engine.tables["sparse"].dim
    got = _rows_of(fresh, fresh.engine.store_of("sparse").lookup(z["fids"]))
    mine = _rows_of(trainer,
                    trainer.engine.store_of("sparse").lookup(z["fids"]))
    assert len(z["fids"]) > 0
    assert np.array_equal(got[:, :dim], z["values"]), "restored delta rows"
    assert np.array_equal(mine[:, :dim], z["values"]), "saved delta rows"
    r["rows"], r["applied"] = len(z["fids"]), applied
    return r


def _ckpt_round(trainer, fresh, work):
    """A checkpoint with the archive, restored into `fresh`: its archive
    and its live rows by id equal the trainer's."""
    from monolith_tpu_torch.training import checkpoint
    t0 = time.perf_counter()
    path = checkpoint.save(trainer, work)
    save_s = time.perf_counter() - t0
    checkpoint.restore(fresh, work)
    a, b = (t.engine.archive_of("sparse") for t in (trainer, fresh))
    (af, ar, _, _), (bf, br, _, _) = a.map.save(), b.map.save()
    oa, ob = np.argsort(af), np.argsort(bf)
    assert len(af) > 0 and np.array_equal(af[oa], bf[ob])
    assert np.array_equal(a.values[ar[oa]], b.values[br[ob]])
    f1, r1 = trainer.engine.store_of("sparse").save()[:2]
    f2, r2 = fresh.engine.store_of("sparse").save()[:2]
    o1, o2 = np.argsort(f1), np.argsort(f2)
    assert np.array_equal(f1[o1], f2[o2])
    assert np.array_equal(_rows_of(trainer, r1[o1]), _rows_of(fresh, r2[o2]))
    return save_s, _tree_bytes(path), len(af)


def _st_hold(exchange, mesh, tiered, delta, work):
    """19a for one exchange on a world of one: the tiered ShardedTrainer
    beside the tiered Trainer on the same batches, under deterministic
    algorithms, equal bit for bit; then its delta and its checkpoint."""
    import torch
    from monolith_tpu_torch.parallel import ShardedTrainer
    from monolith_tpu_torch.training.trainer import Trainer
    sz = _st_sizes(ST_CAP)

    def make():
        return ShardedTrainer(_st_task(sz), _st_config(sz, exchange=exchange),
                              mesh)
    sharded = make()
    single = Trainer(_st_task(sz), _st_config(sz), device=mesh.device)

    def gap():
        return max(_gap(sharded.table_states["sparse"]["data"],
                        single.table_states["sparse"]["data"]),
                   _dense_gap(sharded, single))
    with _Deterministic():
        r = _st_sequence(sharded, _st_data(sz), tiered)
        want, _ = _steps(single, r["batches"], 0, Launches())
        assert want == r["losses"], (want, r["losses"])
        assert single.spill_expired(ST_SPILL) == r["spilled"]
        want, _ = _steps(single, r["revive_batches"], ST_STEPS, Launches())
        assert want == r["revive_losses"], (want, r["revive_losses"])
        want = [float(single.train_step(*p, ts=ST_STEPS + ST_REVIVE)["loss"])
                for p in r["block_batches"]]
        assert np.array_equal(np.float32(want), r["block_losses"]), want
        r["gap"] = gap()
        assert r["gap"] == 0.0, r["gap"]
        evals = [_st_data(sz).batch()]
        r["eval"] = tiered.run(lambda: sharded.evaluate(iter(evals)))
        assert r["eval"] == single.evaluate(iter(evals)), r["eval"]
    r["valid_rows"] = _hold_kernels_on(sharded, r.pop("seen"))
    del single
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    r["delta"] = _delta_round(sharded, make(), os.path.join(work, "delta"),
                              ST_STEPS, delta)
    r["ckpt"] = _ckpt_round(sharded, make(), os.path.join(work, "ckpt"))
    return r


def rank_19b(rank, work, sz):
    """One rank of 19b (started by parallel.launch, two gloo ranks on
    cuda:0 or on the CPU): 19a's sequence on a tiered ShardedTrainer of 2
    shards of 2^20 rows, both exchanges, then its delta restored into 2
    fresh ranks and its checkpoint into 2 more. Returns, by exchange, the
    losses, dense params, the rank's live rows by id, the spilled and
    revived counts and the numbers logged, and the launches of the
    sequence and of the delta."""
    import torch
    from monolith_tpu_torch.embedding import table as table_lib
    from monolith_tpu_torch.parallel import ShardedTrainer, make_mesh
    from monolith_tpu_torch.parallel.launch import rank_device
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(device=rank_device())
    out = {}
    for exchange in ("allgather", "a2a"):
        tiered, delta = Launches(), Launches()

        def make():
            return ShardedTrainer(_st_task(sz), _st_config(
                sz, num_shards=2, exchange=exchange), mesh)
        tr = make()
        r = _st_sequence(tr, _st_data(sz), tiered)
        r.pop("seen")
        for k in ("batches", "revive_batches", "block_batches"):
            r.pop(k)
        r["delta"] = _delta_round(tr, make(), os.path.join(
            work, f"delta-{exchange}"), ST_STEPS, delta)
        r["ckpt"] = _ckpt_round(tr, make(), os.path.join(
            work, f"ckpt-{exchange}"))
        fids, rows = tr.engine.store_of("sparse").save()[:2]
        order = np.argsort(fids)
        r["fids"] = fids[order]
        r["live"] = table_lib.full_rows(
            tr.engine.tables["sparse"], tr.table_states["sparse"],
            torch.from_numpy(rows[order]).to(tr.device)).cpu().numpy()
        r["dense"] = {k: p.detach().cpu().numpy()
                      for k, p in tr.module.named_parameters()}
        r["launches"] = {"sharded_tiered": tiered.total,
                         "delta": delta.total}
        out[exchange] = r
        del tr
    return out


def _hold_19b(card, cpu):
    """Two card ranks against two CPU ranks: losses, dense params and each
    shard's live rows by id within ST2_RTOL, spilled and revived counts
    exactly. Returns the largest gap over the largest magnitude."""
    gaps = []
    for g, c in zip(card, cpu):
        for exchange in g:
            x, y = g[exchange], c[exchange]
            for k in ("losses", "revive_losses", "block_losses"):
                np.testing.assert_allclose(x[k], y[k], rtol=ST2_RTOL)
            for k in ("spilled", "revived", "block_revived",
                      "archive_entries"):
                assert x[k] == y[k], (exchange, k, x[k], y[k])
            assert x["delta"]["rows"] == y["delta"]["rows"]
            np.testing.assert_array_equal(x["fids"], y["fids"])
            pairs = [(x["live"], y["live"])] + [
                (x["dense"][k], y["dense"][k]) for k in x["dense"]]
            for a, b in pairs:
                den = float(np.abs(b).max()) or 1.0
                gaps.append(float(np.abs(a - b).max()) / den)
    assert max(gaps) <= ST2_RTOL, max(gaps)
    return max(gaps)


def rank_19c(rank, argv):
    """train.main's rank body (`train.rank_main`) in a rank that
    parallel.launch started; returns its results, its launches and the ms
    of each train step (synchronized)."""
    from monolith_tpu_torch import ops, train
    from monolith_tpu_torch.parallel import ShardedTrainer
    times, real = [], ShardedTrainer.train_step

    def timed(self, *a, **k):
        t0 = time.perf_counter()
        out = real(self, *a, **k)
        _sync()
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    ShardedTrainer.train_step = timed
    ops.reset_launch_counts()
    try:
        out = train.rank_main(rank, argv)
    finally:
        ShardedTrainer.train_step = real
    return out, ops.launch_counts(), times


def rank_19d(rank, n):
    """`dryrun_multichip(rank, n)` in a launched rank; returns its losses
    and its launches."""
    from monolith_tpu_torch import ops
    from monolith_tpu_torch.parallel.dryrun import dryrun_multichip
    ops.reset_launch_counts()
    out = dryrun_multichip(rank, n)
    return out, ops.launch_counts()


def _phase_19a(device, work):
    import torch.distributed as dist
    tiered, delta = Launches(), Launches()
    mesh = _world_of_one(device)
    rs = {}
    try:
        for exchange in ("allgather", "a2a"):
            r = rs[exchange] = _st_hold(exchange, mesh, tiered, delta,
                                        os.path.join(work, exchange))
            log(f"19a deepfm_f32 tiered {exchange} (one {mesh.backend} "
                f"rank, capacity 2^21, ttl {ST_TTL}, ts = step): "
                f"{ST_STEPS} steps, spill_expired({ST_SPILL}), "
                f"{ST_REVIVE} steps and a synchronous block of {ST_K} "
                f"whose user ids were spilled, 1 eval batch, bit for bit "
                f"equal to the tiered Trainer under deterministic "
                f"algorithms (largest gap {r['gap']}; losses, spilled "
                f"counts, pools, dense params, eval {r['eval']}); spilled "
                f"{r['spilled']['sparse']} rows in {r['spill_s']:.3f} s "
                f"(archived = K1's plain gather bit for bit, rows zeroed); "
                f"revived rows a step {r['revived']}, in the block "
                f"{r['block_revived']}, each handed to the model as its "
                f"archived state bit for bit; ms/step (median, "
                f"synchronized, deterministic algorithms): steps "
                f"{r['ms']:.3f}, reviving steps {r['revive_ms']:.3f}, the "
                f"reviving block {r['block_ms']:.3f}; save_delta "
                f"{r['delta']['rows']} rows, {r['delta']['bytes']} bytes in "
                f"{r['delta']['save_s']:.3f} s, restore_delta into a fresh "
                f"rank {r['delta']['restore_s']:.3f} s (rows equal by id); "
                f"checkpoint with the archive ({r['ckpt'][2]} entries, "
                f"{r['ckpt'][1]} bytes, save {r['ckpt'][0]:.3f} s) restored "
                f"equal; K1/K2 bit for bit on its pool ({r['valid_rows']} "
                f"valid rows)")
    finally:
        dist.destroy_process_group()
    # per exchange: 16 + 2 steps, the spill's gather and zeroing, the
    # block of 4, the eval batch; the delta's gather, restore's K1 + K2
    _expect_launches(tiered.total, {
        "gather_rows": 2 * (ST_STEPS + ST_REVIVE + 1 + ST_K + 1),
        "scatter_rows": 2 * (ST_STEPS + ST_REVIVE + 1 + ST_K)}, "19a")
    _expect_launches(delta.total, {"gather_rows": 2 * 2,
                                   "scatter_rows": 2 * 1}, "19a delta")
    return tiered, delta


def _phase_19b(device, work):
    from monolith_tpu_torch.parallel.launch import launch
    t0 = time.time()
    sz = _st_sizes(ST2_CAP)
    card = launch(rank_19b, 2, backend="gloo", device=device,
                  args=(os.path.join(work, "card"), sz))
    t1 = time.time()
    cpu = launch(rank_19b, 2, device="cpu",
                 args=(os.path.join(work, "cpu"), sz))
    gap = _hold_19b(card, cpu)
    tiered, delta = Launches(), Launches()
    for g in card:
        for exchange, r in g.items():
            tiered.add(r["launches"]["sharded_tiered"])
            delta.add(r["launches"]["delta"])
    a = card[0]["a2a"]
    log(f"19b deepfm_f32 tiered, two gloo ranks sharing {device} through "
        f"parallel.launch (2^20 rows a shard), both exchanges: 19a's "
        f"sequence equal to two CPU ranks within {ST2_RTOL} (largest gap "
        f"over the largest magnitude {gap:.3g}: losses, dense params, each "
        f"shard's live rows by id; spilled and revived counts exactly); "
        + "; ".join(
            f"{x}: spilled {card[0][x]['spilled']['sparse']} (all ranks), "
            f"revived rows a step by rank "
            f"{[g[x]['revived'] for g in card]}, in the block "
            f"{[g[x]['block_revived'] for g in card]}, ms/step steps "
            f"{[round(g[x]['ms'], 3) for g in card]}, reviving "
            f"{[round(g[x]['revive_ms'], 3) for g in card]}, block "
            f"{[round(g[x]['block_ms'], 3) for g in card]}; delta "
            f"{[g[x]['delta']['rows'] for g in card]} rows a shard, "
            f"{card[0][x]['delta']['bytes']} bytes, save "
            f"{[round(g[x]['delta']['save_s'], 3) for g in card]} s, "
            f"restored into 2 fresh ranks "
            f"{[round(g[x]['delta']['restore_s'], 3) for g in card]} s"
            for x in card[0])
        + f"; {t1 - t0:.1f} s on the card, {time.time() - t1:.1f} s on the "
          f"CPU")
    assert a["delta"]["applied"] == sum(g["a2a"]["delta"]["rows"]
                                        for g in card)
    return tiered, delta


def _phase_19c(device, work):
    """train.main's rank body on two gloo ranks sharing the card: train,
    eval and a per-shard checkpoint, which the one-rank Trainer restores
    by id."""
    import torch
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.parallel.launch import launch
    from monolith_tpu_torch.training import checkpoint
    from monolith_tpu_torch.training.trainer import Trainer
    model_dir = os.path.join(work, "model")
    args = {"embedding_dim": 16, "capacity_per_shard": ST2_CAP,
            "hidden": [256, 128, 64], "init_scale": 0.0}
    sz = _st_sizes(ST2_CAP)
    argv = ["--task", "deepfm", "--task_args", json.dumps(args),
            "--batch_size", str(sz["B"]), "--unique_cap", str(sz["U"]),
            "--new_cap", str(sz["U"]), "--steps", str(CLI19_STEPS),
            "--eval_steps", str(CLI19_EVAL), "--mode", "train_and_eval",
            "--log_every", "0", "--num_shards", "2",
            "--model_dir", model_dir]
    t0 = time.time()
    ranks = launch(rank_19c, 2, backend="gloo", device=device, args=(argv,))
    wall = time.time() - t0
    out = ranks[0][0]
    for res, _, _ in ranks:  # every rank returns the global loss and AUC
        for phase in ("train", "eval"):
            for k in ("loss", "auc"):
                assert res[phase][k] == out[phase][k], (phase, k, ranks)
    for phase in ("train", "eval"):
        assert np.isfinite(out[phase]["loss"]), out
    launches = Launches()
    for _, counts, _ in ranks:
        launches.add(counts)
    assert all(len(t) == CLI19_STEPS for _, _, t in ranks)
    single = Trainer(DeepFMTask(**dict(args, capacity_per_shard=2 * ST2_CAP,
                                       hidden=tuple(args["hidden"]))),
                     _st_config(sz, tiered=False), device=device)
    assert checkpoint.restore(single, model_dir) == CLI19_STEPS
    step_dir = os.path.join(model_dir, f"ckpt-{CLI19_STEPS}", "tables")
    rows_checked = 0
    for s in range(2):
        z = np.load(os.path.join(step_dir, f"sparse-s{s}.npz"))
        rows = single.engine.stores["sparse"].lookup(z["fids"])
        assert (rows >= 0).all()
        got = _rows_of(single, rows)[:, :z["pool"].shape[1]]
        assert np.array_equal(got, z["pool"][z["rows"]]), s
        rows_checked += len(rows)
    del single
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    ms = [float(np.median(t[2:])) for _, _, t in ranks]
    log(f"19c train.main's rank body, --num_shards 2 on two gloo ranks "
        f"sharing {device} (parallel.launch; deepfm_f32, 2^20 rows a shard, "
        f"the CLI's synthetic stream): {CLI19_STEPS} steps, {CLI19_EVAL} "
        f"eval batches: {out}; ms/step by rank (median of steps 3-"
        f"{CLI19_STEPS}, synchronized) {np.round(ms, 3).tolist()}; "
        f"the per-shard checkpoint restored into the one-rank Trainer "
        f"(2 -> 1), {rows_checked} rows equal by id; {wall:.1f} s for the "
        f"launch")
    return launches


def _phase_19d(device):
    """dryrun_multichip on one NCCL rank and on two gloo ranks sharing the
    card (on the CPU for a rehearsal)."""
    from monolith_tpu_torch.parallel.launch import launch
    launches = Launches()
    where = ({"device": "cpu"} if device == "cpu" else {})
    for n, kw in ((1, where), (2, {"backend": "gloo", "device": device}
                                   if device != "cpu" else where)):
        t0 = time.time()
        ranks = launch(rank_19d, n, args=(n,), **kw)
        for res, counts in ranks:
            launches.add(counts)
            assert all(np.isfinite(v) for c in res.values()
                       for v in c.values()), res
        log(f"19d dryrun_multichip({n}) on {n} "
            f"{'NCCL' if n == 1 and device != 'cpu' else 'gloo'} rank(s): "
            f"{ranks[0][0]}; {time.time() - t0:.1f} s")
    assert all(launches.total.get(k, 0) > 0 for k in (
        "gather_rows", "scatter_rows", "stochastic_round_bf16")), \
        launches.total
    return launches


def _phase_19e(device):
    """scaling_bench at S = 1 (in this process) and 2 (two gloo ranks on
    the card); returns the one-rank run's launches."""
    import io
    from contextlib import redirect_stdout

    from monolith_tpu_torch import scaling_bench
    argv = ["--sizes", "1,2"] + (["--cpu"] if device == "cpu"
                                 else ["--gloo-one-card"])
    launches = Launches()
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = launches.run(lambda: scaling_bench.main(argv))
    for line in buf.getvalue().strip().splitlines()[:-1]:
        log(f"19e {line}")
    log(f"19e scaling_bench JSON: {json.dumps(out)}")
    for n in (1, 2):
        cell = out[f"mesh{n}"]
        assert np.isfinite(cell["examples_per_sec"]) and \
            cell["examples_per_sec"] > 0, cell
    assert out["ranks_share_one_device"]
    return launches


def phase_launch_and_tiered(device="cuda"):
    """Phase 19; returns the launches by path ("sharded_tiered": 19a and
    19b's card ranks; "delta": their deltas; "launch": 19c-19e's ranks and
    19e's one-rank run)."""
    import gc
    import shutil
    import tempfile

    import torch
    t0 = time.time()
    card = "cuda:0" if device == "cuda" else "cpu"
    work = tempfile.mkdtemp(prefix="chip_smoke_19_")
    try:
        tiered, delta = _phase_19a(device, os.path.join(work, "a"))
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t1 = time.time()
        b_tiered, b_delta = _phase_19b(card, os.path.join(work, "b"))
        tiered.add(b_tiered.total)
        delta.add(b_delta.total)
        t2 = time.time()
        launched = _phase_19c(card, os.path.join(work, "c"))
        t3 = time.time()
        launched.add(_phase_19d(card).total)
        t4 = time.time()
        launched.add(_phase_19e(device).total)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    paths = {"sharded_tiered": tiered.total, "delta": delta.total,
             "launch": launched.total}
    for path, counts in paths.items():
        assert counts.get("gather_rows", 0) > 0 and \
            counts.get("scatter_rows", 0) > 0, (path, counts)
    log(f"phase 19: {time.time() - t0:.1f} s (19a {t1 - t0:.1f}, 19b "
        f"{t2 - t1:.1f}, 19c {t3 - t2:.1f}, 19d {t4 - t3:.1f}, 19e "
        f"{time.time() - t4:.1f}); launches {paths}")
    return paths


# ----------------------------------------------------------------------
# phase 20: bench.py's default multislot, one f32 pool of 2,281,701,376 B
# ----------------------------------------------------------------------

#: the first row of the f32 multislot pool that starts past byte 2^31
MS_F32_PAST_2GIB = (1 << 31) // (WIDTH * 4)     # 4,194,304
MS_F32_TOP = 8192                                # 20a's round trip


def phase_rows_past_2gib(floor):
    """20a: K1/K2 on the f32 multislot pool [4456448, 128] (2,281,701,376
    B) at bench_rows' case, bit for bit and timed as phase 3, with at
    least 2,000 of the case's valid rows past byte 2^31; then K2 of fresh
    values into exactly the top 8,192 rows (row 4,456,447 included) and K1
    of the same rows, each bit for bit against its plain version on a
    copy of the pool. Returns the K1/K2 entries."""
    import torch
    from monolith_tpu_torch.bench_rows import SHAPES, make_case
    from monolith_tpu_torch.ops import scatter as ops
    cap, width, dtype, u = SHAPES["multislot_f32"]
    pool, rows, values = make_case(cap, width, dtype, u)
    assert pool.numel() * pool.element_size() == 2_281_701_376
    past = int((rows >= MS_F32_PAST_2GIB).sum())
    assert past >= 2000, past
    kernels = phase_rows("multislot_f32", floor, (pool, rows, values))
    del values
    top = torch.arange(cap - MS_F32_TOP, cap, dtype=torch.int32,
                       device="cuda")
    fresh = torch.randn((MS_F32_TOP, width), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(3))
    plain = pool.clone()
    ops.scatter_rows(pool, top, fresh)
    ops.scatter_rows_plain(plain, top, fresh)
    out = ops.gather_rows(pool, top)
    torch.cuda.synchronize()
    assert torch.equal(pool.view(torch.int32), plain.view(torch.int32)), \
        "scatter_rows differs from its plain version on the top rows"
    assert torch.equal(out.view(torch.int32), ops.gather_rows_plain(
        plain, top).view(torch.int32)), \
        "gather_rows differs from its plain version on the top rows"
    assert torch.equal(out.view(torch.int32), fresh.view(torch.int32))
    log(f"20a K1/K2 past 2 GiB: {past} of the case's {int((rows >= 0).sum())} "
        f"valid rows start past byte 2^31 (row {MS_F32_PAST_2GIB} on); K2 "
        f"of fresh values into the top {MS_F32_TOP} rows ({cap - MS_F32_TOP}"
        f"..{cap - 1}, the last at byte {(cap - 1) * width * 4}), then K1 of "
        f"them: bit for bit against the plain versions")
    return kernels


def phase_multislot_f32():
    """20b-20f, bench.py:224-242 without MT_BENCH_DTYPE (profile_step's
    `multislot`: one f32 pool [4456448, 128], f32 tower, no rounding) at
    full width: 20b the per-step path, 20c the synchronous block, 20d the
    asynchronous block (MT_BENCH_ASYNC=1), 20e the small f32 variant on
    the card against the CPU, 20f the per-step path binned at 1 GiB
    (MT_BENCH_MERGE_MAX_GB=1: pools of 2^21, 2^21 and 2^18 rows). Returns
    the launches by path."""
    import gc

    import torch
    from monolith_tpu_torch.profile_step import CONFIGS
    t0 = time.time()
    steps, evals, n = PATH_STEPS, PATH_EVALS, BLOCK_K * BLOCKS

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    trainer, data = CONFIGS["multislot"]()
    pool = trainer.table_states["table_all"]["data"]
    assert pool.dtype == torch.float32 and tuple(pool.shape) == \
        (MS_CAP, WIDTH), (pool.dtype, pool.shape)
    batches = [data.batch() for _ in range(steps + evals)]
    per_step, losses = drive_path(
        "20b multislot_f32", trainer, batches, steps, evals,
        {"gather_rows": steps + evals, "scatter_rows": steps,
         "stochastic_round_bf16": 0})
    del trainer, data, pool, batches
    free()
    trainer, data = CONFIGS["multislot"](steps_per_dispatch=BLOCK_K)
    block = drive_block_path(
        "20c multislot_f32 synchronous", trainer, data,
        {"gather_rows": 1 + n + 1, "scatter_rows": 1 + n,
         "stochastic_round_bf16": 0},
        losses, same=PATH_STEPS, rtol=1e-4, falling=True)["launches"]
    del trainer, data
    free()
    trainer, data = CONFIGS["multislot"](steps_per_dispatch=BLOCK_K,
                                         async_optimize=True)
    block_async = drive_block_path(
        "20d multislot_f32 asynchronous", trainer, data,
        {"gather_rows": 1 + 2 * n + 1, "scatter_rows": 1 + n,
         "stochastic_round_bf16": 0},
        losses, same=2, rtol=1e-4, falling=True)["launches"]
    del trainer, data
    free()
    phase_multislot_card_vs_cpu("f32 (20e)", 1e-4, table_dtype=torch.float32,
                                stochastic_rounding=False, dense_dtype=None)
    trainer, data = CONFIGS["multislot"](merge_max_gb=1.0)
    pools = {t: (st["data"].dtype, tuple(st["data"].shape))
             for t, st in trainer.table_states.items()}
    table_rows = MS_CAP // 17            # 2^18 rows a table
    assert pools == {"table_all_0": (torch.float32, (8 * table_rows, WIDTH)),
                     "table_all_1": (torch.float32, (8 * table_rows, WIDTH)),
                     "table_hist": (torch.float32, (table_rows, WIDTH))}, \
        pools
    batches = [data.batch() for _ in range(steps + evals)]
    binned, _ = drive_path(
        "20f multislot_f32 binned at 1 GiB", trainer, batches, steps, evals,
        {"gather_rows": 3 * (steps + evals), "scatter_rows": 3 * steps,
         "stochastic_round_bf16": 0})
    del trainer, data, batches
    free()
    paths = {"per_step": per_step, "block": block,
             "block_async": block_async, "binned": binned}
    log(f"phase 20: {time.time() - t0:.1f} s; launches {paths}")
    return paths


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.time()
    phase_build()
    from monolith_tpu_torch import timing
    timing.warm_up()
    floor = timing.event_floor_ms()
    log(f"event floor: {floor:.4f} ms (an empty kernel between two events, "
        f"after the L2 flush, as every kernel below is timed)")
    kernels = phase_rows("deepfm_f32", floor)
    kernels += phase_rows("multislot_bf16", floor)
    kernels += phase_rounding("multislot_bf16", floor)
    torch.cuda.empty_cache()
    for path in OUT_OF_STEP_SHAPES:
        phase_rows_out_of_step(path)
        torch.cuda.empty_cache()
    f32_kernels = phase_rows_past_2gib(floor)
    torch.cuda.empty_cache()
    launches, losses = {}, {}
    launches["deepfm_f32"], losses["deepfm_f32"] = phase_deepfm_path()
    torch.cuda.empty_cache()
    launches["multislot_bf16"], losses["multislot_bf16"] = \
        phase_multislot_path()
    torch.cuda.empty_cache()
    blocks = {"deepfm_f32": phase_deepfm_block_path(losses["deepfm_f32"])}
    torch.cuda.empty_cache()
    blocks["multislot_bf16"] = phase_multislot_async_block_path(
        losses["multislot_bf16"])
    serving_launches = phase_out_of_the_trainer(blocks["deepfm_f32"],
                                                blocks["multislot_bf16"])
    block_launches = {p: b["launches"] for p, b in blocks.items()}
    del blocks
    torch.cuda.empty_cache()
    expiry_launches = phase_expiry_and_tiering()
    torch.cuda.empty_cache()
    cli_launches, mr_kernels, mr_case = phase_front_door(floor)
    torch.cuda.empty_cache()
    realtime_launches = phase_realtime()
    torch.cuda.empty_cache()
    zoo_launches = phase_zoo()
    torch.cuda.empty_cache()
    library_launches = phase_library()
    torch.cuda.empty_cache()
    sharded_launches = phase_sharded()
    torch.cuda.empty_cache()
    multihost_launches = phase_multihost()
    torch.cuda.empty_cache()
    soa_kernels, soa_launches, soa_cases, soa_x = phase_soa(floor)
    torch.cuda.empty_cache()
    launch_paths = phase_launch_and_tiered()
    torch.cuda.empty_cache()
    f32_launches = phase_multislot_f32()
    for k in kernels:
        # each path was driven with the counts set to 0 just before it;
        # "serving" is the export and the trainer's eval predictions (both
        # paths) and the streaming push and the delta (deepfm_f32);
        # "expiry" the train steps, evictions and spills of phase 11,
        # "cli" phase 12's train.main, "realtime" phase 13's steps,
        # exports and sync rounds, "zoo" phase 14's full-width runs and
        # "library" phase 15a's (deepfm_f32: those pools are [2^21, 128]
        # f32 too)
        k["launches_by_path"] = {
            "per_step": launches[k["path"]][k["name"]],
            "block": block_launches[k["path"]][k["name"]],
            "serving": serving_launches[k["path"]][k["name"]],
            "sharded": sharded_launches[k["path"]][k["name"]],
            "multihost": multihost_launches[k["path"]][k["name"]],
            "soa": soa_launches["soa"][k["path"]][k["name"]],
            "multi_array": soa_launches["multi_array"][k["path"]][k["name"]]}
        if k["path"] == "deepfm_f32":
            k["launches_by_path"]["expiry"] = expiry_launches[k["name"]]
            k["launches_by_path"]["cli"] = cli_launches[k["name"]]
            k["launches_by_path"]["realtime"] = realtime_launches[k["name"]]
            k["launches_by_path"]["zoo"] = zoo_launches[k["name"]]
            k["launches_by_path"]["library"] = library_launches[k["name"]]
            # phase 19: the tiered sharded runs, their deltas, and the
            # launched ranks' K1/K2 (19d's bf16 multislot included)
            for path in ("sharded_tiered", "delta", "launch"):
                k["launches_by_path"][path] = launch_paths[path].get(
                    k["name"], 0)
        elif k["name"] == "stochastic_round_bf16":
            # K3 runs in phase 19 only in 19d's bf16 multislot
            k["launches_by_path"]["launch"] = launch_paths["launch"][
                k["name"]]
        k["launches"] = sum(k["launches_by_path"].values())
    # "cli": 12d's train.main (MovieRanking, two tables)
    for k in mr_kernels:
        k["launches"] = sum(k["launches_by_path"].values())
    # phase 20's paths ("binned": 20f's three pools, [2^21, 128] f32 twice
    # and [2^18, 128])
    for k in f32_kernels:
        k["launches_by_path"] = {p: c[k["name"]]
                                 for p, c in f32_launches.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    kernels += mr_kernels + soa_kernels + f32_kernels
    phase_block_card_vs_cpu()
    phase_card_vs_cpu()
    phase_multislot_card_vs_cpu()
    phase_multislot_trains()
    phase_northstar()
    torch.cuda.empty_cache()
    phase_kernel_durations(kernels, {"movie_ranking": mr_case, **soa_cases},
                           soa_x)
    log(f"total {time.time() - t0:.1f} s")
    # the card again, within the end of the output that a caller keeps
    log(smi[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
