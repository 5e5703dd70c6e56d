"""Smoke run of the PyTorch/CUDA port on one GPU: builds the hand-written
kernels, holds each against its plain PyTorch version at the main path's
shapes, drives the device-routed ComplEx KGE training step through the
parameter manager at full width (eagerly, and as run_scan windows
replayed from a CUDA graph), and the RESCAL step the same way, with
the prefetch pipeline on (the
default) and off, checks a small replica run against the CPU, drives
a pull-driven flow through the pipeline's staged buffers and the
background planner under concurrent pushes, runs the KGE application
end to end on both routing paths, then the word2vec step and
application and the matrix-factorization application the same way,
serves lookups and embedding-bag reads through the serving plane,
runs the tiered store, compressed sync rounds and episodic execution,
drills checkpoint chains under injected faults and request-flight
tracing, captures a workload, replays it, trains the learned policy
on it and ranks knob candidates by replay, and runs the multi-process
parameter manager: a loopback cluster of four nodes on the card, and
the KGE app as two processes through the port's launcher; runs the BSP
collective exchange (K13 over CUDA IPC) between three launched
processes with per-rank checkpoints, and the streaming north-star
scenario; and runs the north-star scale runs (a Wikidata5M-sized ComplEx
table of 8.95 GiB, 1B-words-sized word2vec, MovieLens-25M-sized MF)
through python -m adapm_tpu_torch.northstar's entry points.

    python3 chip_smoke.py [--json PATH]
    python3 chip_smoke.py --main-path-only   (phase 1 and phase 3's
        step alone: copied into an earlier tree of the port, it times
        that tree's step the same way)
    python3 chip_smoke.py --kernels K4,K8    (phase 1 and the named
        kernels' parts of phase 2 alone, the same way; K1 (at both
        widths), K3, K4, K4mp (K4's multi-process form), K8-K17 can be
        named)
    python3 chip_smoke.py --pipeline-only    (phase 1, phase 3 with the
        pipeline on and off, phases 11 and 12, checked as in the full
        run)
    python3 chip_smoke.py --fault-only       (phase 1 and phase 14,
        checked as in the full run)
    python3 chip_smoke.py --replay-only      (phase 1 and phase 15,
        checked as in the full run)
    python3 chip_smoke.py --mp-only          (phase 1 and phase 16,
        checked as in the full run)
    python3 chip_smoke.py --collective-only  (phase 1 and phase 17,
        checked as in the full run)
    python3 chip_smoke.py --stream-only      (phase 1 and phase 18,
        checked as in the full run)
    python3 chip_smoke.py --northstar-only   (phase 1 and phase 19,
        checked as in the full run)

Phases (any failure raises and exits non-zero):
  1. card name + power limit; build the kernels (nvcc, sm_90a).
  2. each kernel vs its plain version at the main path's shapes
     (K1 routed_gather: 143,360 rows of 512 f32, both forms, bitwise;
     K3 ordered_scatter_add: the same rows with zipf duplicates, bitwise
     and deterministic over two runs, timed as the whole wrapper, as its
     fold alone (ordering done before the first event) and as its
     ordering pass and torch.sort alone, and again on uniform keys of
     the same n (the gap is the hot runs' tail); the multi-segment forms
     of K1 and K3 bitwise at the step's four-role split
     4,096 x 3 + 131,072; K2 adagrad_update: [143,360, 256]
     within tolerance; K4 pool_eval_counts: 64 queries against a
     200,000-entity pool in 65,536-key chunks: exact on integer-valued
     data, and ComplEx K=256 and RESCAL K=128 on random data under the
     near-tie rule, each at B=64 and at the app's tail batch B=36, with
     the share of the bound, the launch plan and the kernel's registers,
     spills and static shared memory from its ptxas log; and at the
     benchmark eval cell's shape (4,594,485 candidates, K=512 through
     rows of 1,024 f32, B=64) the one-CTA-a-block form's three plans
     through its C entry and the wrapper's pair form, counts bitwise
     alike and within the near-tie rule, device ms beside the bound and
     matmul + compare + sum, K4_FORMS; K4's
     multi-process form (models/kge.py make_pool_eval_counts_mp, K4 over
     one rank's half of those candidates: 100,000 owned entities in two
     65,536-key tiles), the query triples as rows and the true score an
     input: exact on integer-valued rows and under the near-tie rule on
     random rows, ComplEx and RESCAL each at B=64 and B=36, timed as K4
     alone and with its query forming, beside matmul + compare + sum
     over the owned rows); K17 pool_eval_dist (RotatE's count by
     distance) on the same 200,000-entity pool, d=128 read through the
     row stride, at B=64 and B=36: exact on integer-valued rows with
     zero imaginary halves and true distances half-way between integers,
     within K17's near-tie rule on random RotatE queries and equal over
     two runs, device ms in the trace and between events beside its
     bound (the SFU's square roots), the launch plan and ptxas; at the
     benchmark RotatE cell's shape (4,594,485 candidates, d=256 through
     rows of 1,024 f32, B=64) within the near-tie rule, device ms beside
     the bound and the plain version's seconds; RotatE's eval program
     (models/kge.py make_pool_eval_counts) on a 201,000-key server's
     pool, 5 batches whose launches must be exactly 3 K1 and one K17 a
     batch; and a small --model rotate app run on the card (device
     routes: K1, K2, K3, K17, its loss falling); K5
     complex_step: the step's rows (K1's buffer, zipf duplicates) at
     B=4096, N=32, d=128 for self_adv_temp T in {0, 1} and l2 in {0, 0.1},
     loss and update rows within rtol 1e-5 / atol 1e-6, bitwise over two
     runs, and K2 on K5's own gradient output equal to K5's update rows
     bit for bit, timed beside the parent's eager model math on the same
     rows (KgeLoss under autograd, then four K2 launches); K16
     rescal_step the same way on the RESCAL step's rows (K1's gathers of
     an entity pool of 256-f32 rows and a relation pool of 32,768-f32
     rows: B=4096, N=32, d=128), timed beside the parent's eager model
     math with its peak memory, with its ptxas registers, spills and
     shared memory; K1 and K3 at the relation rows' width (4,096 rows of
     32,768 f32), bitwise their plain versions (K1 also in its
     cache+delta form and its 4-byte form at 32,766 f32), beside
     index_select and index_add_, K1 also in the trace with its launch
     plan; K6 sgns_step
     on the w2v step's rows at bench_w2v's width (B=8,192 pairs, N=5
     negatives drawn from the alias table, d=128: 57,344 rows of 256
     f32, zipf duplicates) and K7 mf_step at B=8,192 ratings, rank 128,
     l2 in {0, 0.01}, each within rtol 1e-5 / atol 1e-6 of its plain
     version, bitwise over two runs and K2 on its gradient bitwise its
     update rows, timed beside the parent's path on the same rows (the
     loss under autograd, then one K2 per role); K8 gather_pool at two
     batches of phase 10's bag path over the 7,116,632-key DLRM table,
     padded as the store pads them: the path's own (8 requests, one per
     client: 54,784 members, 6,656 bags of L=256) and a full coalesced
     batch (64 requests: 438,272 members, 53,248 bags), each in sum and
     mean, every member owner-served (S=1) and again a quarter
     replica-served (S=2, cache + delta), bitwise its plain version and
     over two runs, timed in the trace and between CUDA events beside
     its plain version and embedding_bag(mode="sum") on the same owner
     rows; and, as a diagnosis, the same members re-planned into bags
     of equal length (8-9 members at the path's batch), beside K8's
     times before its redesign (prior_ms: quoted from PERF.md, not
     measured in the run, and kept out of the kernels line). The tiered
     store's kernels, each bitwise its plain version and over two runs:
     K9 gather_cold on one tiered KGE step's pull (143,360 entries of
     512 f32, a third cold, the rest hot rows of a 65,536-row pool) in
     fp32, fp16 and int8 wire rows, beside index_select + torch.where
     over pre-dequantized cold rows; K10 gather_pool_cold at phase 10's
     two bag batches over the DLRM table with 1,048,576 hot rows and
     int8 cold rows (each table's lowest keys hot), sum and mean, the
     cold member share printed, beside embedding_bag over the hot pool
     joined with the pre-dequantized cold rows, and both instantiations'
     ptxas; K11 write_main_rows, 16,384 entries of 512 f32 into a
     65,536-row pool in each format, on promotion's distinct rows and on
     a batch where a quarter of the entries repeat an earlier target and
     some drop (sh >= S, a negative row, OOB padding), its claim scratch
     all -1 after each call and one call's device records its two
     kernels alone, timed as the device time of all a call launches
     beside index_copy_ of the winners' pre-dequantized rows; K12
     sync_compress on 65,536 replica rows
     of 512 f32, half below the threshold, fp16 and int8 (its four
     outputs; no library call computes it); K13 alltoall_put in one
     process at phase 17's leaves (3 destinations, a bucket of 1,024
     i64 keys and 1,024 rows of 512 f32: 2,105,344 bytes a
     destination) into 3 raw-cudaMalloc slabs, every source at both
     parities, bitwise its plain version, each slab unpacking to what
     each source sent, timed in the trace with L2 flushed before each
     launch and warm, beside its plain version and 3 copy_ calls into
     the same slabs. CUDA-event
     times (the median and the min-max spread of 20 launches) of
     kernel, plain version and one library call, and the least time the
     card could take.
  3. the main path: setup(201,000 keys, 512) on cuda, slab fill, a
     DeviceRoutedRunner for ComplEx with on-device negatives (B=4096,
     N=32), warmup, then 32 steps of intent -> step -> drive_rounds
     (delegated to the prefetch pipeline) -> advance_clock; launch
     counts of every kernel over the main path,
     checked per step (one K1, one K5, no K2, one K3: one launch per pool
     class), and the profiler's device operations per step. Then
     run_scan: two servers from one fill, 16 sequential steps on one and
     two windows of K=8 on the other (the first runs eagerly and is
     captured as a CUDA graph, the second replays it): losses and the
     whole main pool bitwise equal; then 4 windows timed against 32
     eager steps of the same runner calls, one window profiled, and the
     number of captures. Then the pipeline on and off from one fill
     (seed 11), in turns (on, off, off with keys staged; three turns,
     cut from six to keep the run's time with phase 13): 3 + 32 eager
     steps (with it on, each step's keys uploaded as
     StagedKeys on its intent path, as the app does; with it off, as
     the turns say), a profiled window of 8 and one more step, then 5
     K=8 windows, each followed by drive_rounds(8) and its clock ticks:
     losses and the whole main pool bitwise equal, the same launches
     every eager step, one capture each; ms/step eager and in windows,
     the training thread's host time by part of a step (intent, key
     staging, step call, drive_rounds), the pipeline's passes and their
     host time on their own thread (timed by the scheduler), device
     operations per step, the busy share and prefetch.report() after
     flush(). The runs off with keys staged part StagedKeys' cost and
     gain from the pipeline's passes. Phase 3 (RESCAL): the same main
     path and run_scan windows with RESCAL's two classes (200,000 entity
     rows of 256 f32, 1,000 relation rows of 32,768 f32; B=4096, N=32,
     zipf keys): per step two K1, one K16, two K3 (one a class), no K2;
     windows bitwise the sequential steps (losses and both main pools);
     ms/step, device ms and operations per step, busy share, peak memory.
  4. replica phase: 2 virtual shards, two workers with competing
     intents (the replica step variant, K1's cache+delta form, K3 in the
     sync merge; one K1, one K5 and two K3 per step, main then delta), the same
     fused steps on cuda and on cpu within
     tolerance, then an add-only push/pull/set/sync sequence on both,
     bitwise.
  5. the KGE app (apps/knowledge_graph_embeddings.py, main's parse and
     run) at full width: ComplEx d=128, 200,000 entities, 409,600
     lowrank triples generated on the card, B=4096, N=32, 2 epochs of
     100 device-routed steps as --scan_steps 8 (12 graph windows and a
     4-step tail per epoch), pool-count eval (K4) after each; launch
     counts of every kernel over the run; the same run with
     --sys.prefetch 0 (the kill switch; once, cut from three turns to
     keep the run's time with phase 13): epoch losses bitwise equal;
     then 64 device-routed steps at --scan_steps 1 (keys pre-uploaded
     as StagedKeys) with the pipeline on and off, profiled: losses
     bitwise equal, busy share, staged-key steps.
  6. the host-routed app path (--no-device_routes, PullSample
     negatives) at the same width for 10 steps; then test_kge_app's
     small configuration on cuda and on cpu (epoch losses within rtol
     1e-4, MRR within 0.02, and the eval counts of one checkpoint under
     the near-tie rule), and its RESCAL form on both (K16 on the card:
     epoch losses within rtol 1e-4), and the RESCAL form on device
     routes in --scan_steps 2 windows (K1, K16, K3, K4, no K2, K16
     replayed from the windows' graphs); then K2's path: a small
     device-routed RESCAL run whose negatives are one [N] batch shared by
     a step's triples (autograd, then one K2 per trainable role).
  7. the word2vec step: setup(200,000 keys, 256) on cuda, bench_w2v's
     slab fill, a DeviceRoutedRunner for SGNS with alias negatives
     (B=8,192, N=5), 32 steps of intent -> step -> sync round -> clock,
     each step's launches checked (one K1, one K6, one K3, no K2), the
     profiler's device operations and ms per step, pairs/s; then
     run_scan windows of K=8 against 16 sequential steps, bitwise
     (losses and main pool), and timed against the same eager calls.
  8. the word2vec app (apps/word2vec.py, main's parse and run) on cuda:
     d=128, N=5, B=8,192, --scan_steps 8, a synthetic zipf corpus of
     20,000 sentences over a 100,000-word generator vocabulary, 2
     epochs: loss finite and falling, K6's wrapper and replayed
     launches adding up to the steps, the device busy share and the
     host seconds; the same run with --sys.prefetch 0: epoch losses
     bitwise equal, the same launches; then the host-routed small
     configuration on cuda and on cpu (epoch losses within rtol 1e-4).
  9. the MF app (apps/matrix_factorization.py) on cuda at rank 128 on a
     MovieLens-1M-sized synthetic matrix (6,040 x 3,706, 1,000,209
     ratings), dsgd, 2 epochs, device routes with --scan_steps 8 and
     host routes: loss falling, K7's launches adding up to the steps;
     each again with --sys.prefetch 0: epoch losses bitwise equal, the
     same launches; then test_mf_app's configuration on cuda and on cpu
     on both routing paths (epoch losses within rtol 1e-4).
 10. the serving plane (adapm_tpu_torch/serve) at full width: (a) flat
     lookups on phase 3's table (201,000 keys of 512 f32): 32 client
     threads of 50 lookups of 64 zipf keys (deadline 1 s), first with
     the default knobs on a quiescent table (every reply bitwise
     Worker.pull), then on fresh keys with 2 dispatchers and a
     65,536-row replica while a pusher adds to the table's cold half
     (after quiesce(), lookups bitwise Worker.pull again, and after a
     forced refresh, lookups of keys the snapshot covers served from the
     replica and bitwise Worker.pull); (b)
     embedding-bag reads at the DLRM-DCNv2 shape: 8 client threads of
     25 lookup_bags requests of 32 samples (26 tables, 832 bags, 6,848
     members a request) over the 7,116,632-key table, segments sum,
     mean, and sum with --sys.serve.bags 0: every reply bitwise
     pool_bags_host over Worker.pull, the third segment bitwise the
     first, K8 launched once per fused batch. Lookups/s and samples/s,
     p50/p99 of serve.latency_s, the mean coalesced batch, the replica
     hit rate, launches, and a profiled rerun of each segment for the
     device busy share and K1's and K8's device time.
 11. a pull-driven flow on phase 3's table with the pipeline on and
     off: one worker, 64 batches of 4,096 zipf keys, intent (lookahead
     2) -> pull -> push -> advance_clock, prefetch_pull "auto": every
     pull bitwise the plain flow's; then a staged batch nothing wrote
     and its pull (a staged hit, bitwise the plain flow's pull), and
     the batch staged again, a push to its keys and its pull
     (invalidated_write counted, bitwise the plain flow's). The
     staged-hit rate, pull p50/p99 on and off, and the K1 launches
     staging made (each staging is one).
 12. the background planner on phase 4's two-shard setup: two worker
     threads push integer values under competing intents while
     start_sync_thread() runs the rounds, then WaitSync -> Barrier ->
     WaitSync, stop_sync_thread(), quiesce(): every row bitwise the
     sequential sum and the same run on the cpu; rounds/s.
 13. tiering and compression at full width: (a) the KGE app of phase 5
     with --sys.tier 1 --sys.tier.hot_rows 65536, once with fp32 and
     once with int8 cold rows: loss finite and falling, at most 65,536
     hot rows a shard, promotions, K4 after each epoch, K9 and K11
     launched, the tier section reported; (b) test_tier.py's storm on
     phase 3's table (values on an int8 grid) tiered at 65,536 hot rows
     beside an untiered shadow on the card, 24 ops of pushes with
     duplicates, sets, promotions, demotions, sync rounds and clock
     ticks, a pull of 16,384 zipf keys after each and the whole table
     after quiesce: bitwise with fp32 cold rows, within two grid steps
     (tier/quant.py grid_step) with int8; (c) phase 10 (b)'s sum
     segment on the DLRM table tiered (1,048,576 hot rows, int8 cold
     rows, values on the int8 grid): every reply bitwise
     pool_bags_host over Worker.pull, K8 or K10 once per fused batch
     (K10 where the batch holds a cold member), samples/s and p50/p99
     beside phase 10's untiered sum segment; (d) phase 12's background
     planner with --sys.sync.compress fp16 and int8: after quiesce()
     every row the sequential sum (bitwise in fp16, whose grid holds
     the integer deltas; within rtol / atol 1e-6 in int8, as
     test_quant.py holds it), K12 launched, the bytes shipped against
     full width and phase 12's; (e) EpisodicRunner over (a)'s tiered
     step (16 steps, episodes of 8, the negatives' 8,192-key
     population intent-pinned hot) against the same steps run
     sequentially: losses and the whole main table bitwise.
 14. checkpoint chains, fault injection and request-flight tracing on
     phase 3's table and step: (a) a server with --sys.fault.spec
     (FAULT_SPEC: transient faults at exec.dispatch, sync.round and
     ckpt.save) and an uninjected shadow take the same steps, the
     background planner running: 16, then a base link (saves retried on
     an injected fault, any other failure fails the run), 8 and a delta,
     8 and a delta, then 8 steps on the injected server that are lost
     with it; restore_chain into a fresh server: main, cache and delta
     pools, placement and clocks bitwise the shadow's at the last save,
     then 8 more steps on both, their generators seeded alike, losses
     and table bitwise; every point fired and was retried; phase 4's
     two-shard setup gives a delta link with dirty replica rows that
     restores bitwise; (b) concurrent flat lookups on the shadow while
     restore_chain(hold_degraded_s) replaces its state: every outcome
     ServeDegradedError, a reply bitwise Worker.pull before, or the
     chain's rows; (c) the chain restored into a tiered server
     (--sys.tier.hot_rows 65536, fp32 cold rows): cold pulls (K9),
     promotion (K11) and the whole table bitwise the chain's; (d)
     phase 10's flat segment untraced and with --sys.trace.flight 1:
     replies bitwise Worker.pull, every lookup's flow complete in the
     export, every device slice above zero and no longer than its
     program; p50/p99 of the four breakdown histograms, lookups/s
     beside the untraced segment; (e) --sys.metrics.report logs lines
     while (d) runs. The planes' own log lines are counted, not printed.
 15. workload traces, decision telemetry, replay and the learned policy
     on phase 3's table over two shards, tiered (65,536 hot rows a
     shard, fp32 cold rows), the background planner at 20 rounds/s
     without the static dirty filter, --sys.serve.slo_ms 2: (a) capture
     with --sys.trace.workload and --sys.trace.decisions: the table
     filled in 4,096-key sets, two worker threads of REPLAY_STEPS (8)
     steps (intent for the next batch of 4,096 zipf keys, pull, push of 4,096
     rows, advance_clock) beside 8 serving clients (12 lookups of 64
     zipf keys each, half tenanted); both traces verify, every event
     kind is present, none dropped or sampled, and reloc, sync, tier
     and prefetch decisions each landed; the same workload uncaptured
     on a fresh server for the capture's cost, and record_kv's host
     time for a 4,096-key event; (b) replays on the card (seed 11):
     twice at speed 100 (equal digest, reads and events), at speed 10
     and with tier_hot_rows halved (equal digest), with seed 12 (another
     digest); (c) the first 96 key-batch events (whole events) replayed
     on the card and on the cpu: equal digests; (d) train_policy twice
     (byte-identical), then replays with every plane learned and in
     shadow mode: the plain digest, consults on the reloc, tier and
     sync planes, none applied in shadow; (e) rank_candidates at speed
     10 over recorded knobs, a quarter of the hot rows and twice the
     channels (each replica synced half as often): a ranked artifact on
     disk. Each part launches K1, K3, K9 and K11 and no kernel another
     path owns.
 16. the multi-process layer: (a) a LoopbackCluster of 4 nodes in this
     process, each a Server on the card over phase 3's key space
     (201,000 keys of 512 f32, integer-valued, each node filling its
     home keys), one worker a node: 8 rounds (4, then 4 profiled)
     of intent for the next 4,096 zipf keys, a pull, a push of
     integer-valued rows to them, a planner round and advance_clock,
     each set of rounds ending in WaitSync -> Barrier -> WaitSync ->
     Barrier; every node's reads of every touched key bitwise the NumPy
     shadow, relocations, replications and keys served after a
     redirect all > 0, no decode error; pull and push p50/p99, keys/s,
     the hop histogram, the fabric's msgs and bytes, K1/K3 launches,
     the busy share of the profiled rounds, the host seconds of each
     part of the phase; (b) 8 more rounds with the wire's
     fault points firing (net.send, net.recv, net.dup, net.delay):
     bitwise again, faults fired; then the survivors replicate the
     hottest keys, one node is killed, and each survivor's membership
     plane detects the death and promotes exactly its replicas of the
     dead node's keys (read back bitwise), counts the rest as
     net.lost_keys, and reports net.failover_s; (c) the KGE app of
     phase 5 (1 epoch of the 409,600 triples, --scan_steps 8) as two
     processes through `python -m adapm_tpu_torch.launcher -n 2`, the
     kernels built here before the ranks start: both ranks report the
     same global eval statistics and counts, and those counts equal a
     one-process K4 eval of the table rank 0 checkpointed after its eval
     (near-tie rule); each rank launches K1, K5, K3 and K4 (in its
     multi-process form) and no kernel another path owns; each rank's
     epoch seconds and examples/s, their sum beside phase 5's one
     process, eval seconds, DCN messages and bytes.
 17. the BSP collective exchange: three processes on the card through
     `python -m adapm_tpu_torch.launcher -n 3` (each re-running this
     script with --coll-rank), each a Server over phase 3's key space
     (integer-valued, each rank filling its home keys) with
     --sys.collective_sync, bucket 1,024 and --sys.collective_cadence
     4: 16 rounds of intent for the next 4,096 zipf keys, a pull, a
     push, a planner round and advance_clock, ending in WaitSync ->
     Barrier -> WaitSync (replica deltas ride K13's exchange at the
     cadence boundaries and the wait points, owners merge with K3 and
     re-gather with K1); every rank's reads of every touched key
     bitwise the NumPy shadow; exchange iterations, rows out and rows in
     > 0; a collective pull and push of 4,096 keys bitwise the shadow;
     one exchange of phase 2's K13 leaves (each rank's from its seed)
     bitwise what the plain put delivers from the same leaves; a
     per-rank save_server, then a restore into three fresh ranks,
     bitwise; each rank launches K13, K1 and K3 and no kernel another
     path owns; each rank's pools on card rank % cards, that card
     current. Reports collective.exchange_s p50/p99, iterations a
     round, rows and bytes exchanged, the per-rank save and restore
     seconds and the host seconds of each part.
 18. the streaming plane: stream/scenario.py run_northstar on the card
     at phase 3's width (201,000 keys of 512 f32; segment A 2 s,
     segment B 24 s):
     ingest through Worker.push (K3), multi-tenant lookup_bags (K8),
     incremental chain links, a kill, restore_chain and replay_tail;
     the restored cursor lags the acked watermark, the table right
     after replay_tail is bitwise an unkilled shadow that applied the
     same batches, and the captured .wtrace replays to one reads_digest
     twice. Reports events/s, the ingest pump's host seconds by part,
     served p99, freshness p99 over the last 20 s of segment B (printed
     only over at least 100 samples; the count beside it) and
     recovery_s.
 19. the north-star runs at full size through the entry points of
     adapm_tpu_torch/northstar.py (python -m adapm_tpu_torch.northstar
     kge --eval, w2v, mf): run_kge (4,600,000 entities, 822 relations,
     d=128, B=4096, N=32 device-drawn negatives, an 8.95 GiB main pool
     filled on the card by bulk_device_init; eval over every entity at
     B=64 and B=512), run_w2v (800,000 words, B=8192, N=5 alias-drawn
     negatives) and run_mf (162,541 x 59,047, rank 128, B=16,384). Each
     prints its JSON line, then its device ms and operations a step and
     busy share (4 steps profiled after its timing; eval batches too),
     peak memory, launches (held to its kernel set: K1, K5, K3 and K4
     for kge, K1, K6, K3 for w2v, K1, K7, K3 for mf, no kernel another
     path owns) and the training thread's host ms by part (intent, step
     call, run_round, mirror refresh). At each run's server shutdown:
     4,096 touched keys (half past element 2^31 of the pool where there
     are so many) pulled through Worker.pull bitwise the pool at their
     address-book coordinates; for kge also 8 eval queries over all
     4.6M candidates within the near-tie rule of K4's plain version,
     and K1 and K3 on 4,096 coordinates of the pool's top rows (past
     element 2^31) bitwise their plain versions; every loss finite.
Phases 11 and 12 run after phase 4, phase 13 after phase 10, phase 14
after phase 13, phase 15 after phase 14, phase 16 after phase 15,
phases 17 and 18 after phase 16, phase 19 last. Every
server's background work is
watched: a prefetch pass, planner round or tier maintenance pass that
raised (logged and retried, never fatal to its loop), a failed
executor program or an executor retry fails the run. Phases 6, 8 and 9 keep --sys.prefetch 0
in their cuda-vs-cpu comparisons at 8 shards (delegated rounds would
make placement depend on timing); their full-width runs take default
knobs, the pipeline on, and phases 8 and 9 run each again with
--sys.prefetch 0: the same epoch losses bitwise, the same launches.
Every path's launch counts are set to 0 just before it runs and read
just after; each path must have launched each of its kernels and no
kernel another path owns (K2, K5-K13, K16).
The near-tie rule: the kernel sums each dot in another order than the
plain version's matmuls, so a count may differ by at most the number of
candidates whose score lies within the f32 dot-product error bound of
the true score (ops/kernels.py pool_eval_counts_plain). K4 is also held
to its plain version exactly on integer-valued data, where every order
of summation gives the same f32 sums. K17's rule allows each
component's modulus 16 units of rounding (its square root is the SFU's
approximate one) and a sum of d terms in any order (ops/kernels.py
pool_eval_dist_plain).
The last two lines are the per-kernel JSON record and the device JSON
line; `--json PATH` also writes the full record (main-path numbers and
the profile included) to PATH. Needs one CUDA card; exits non-zero
without one.
"""
import ctypes
import gc
import itertools
import json
import os
import subprocess
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

# main-path shape (the repo's flagship KGE configuration)
E, R, D_MODEL, B, N = 200_000, 1_000, 128, 4096, 32
EVAL_B, EVAL_CHUNK = 64, 65_536          # the app's eval batch and chunk
K4_BATCHES = (EVAL_B, 36)   # the eval's full batch and its tail at 100
# K4 at the benchmark's eval cell (benchmark/configs/complex_wd5m.json):
# candidates, K, row length, B
K4_CELL = (4_594_485, 512, 1024, EVAL_B)
# K17 at the benchmark's RotatE cell (benchmark/configs/rotate_wd5m.json):
# candidates, complex components d, row length, B
K17_CELL = (4_594_485, 256, 1024, EVAL_B)
STEP_KERNELS = ("routed_gather", "complex_step", "ordered_scatter_add")
# the kernels each ComplEx path launches (K2 runs on phase 6's run with
# a shared [N] batch of negatives)
APP_KERNELS = STEP_KERNELS + ("pool_eval_counts",)
# RESCAL at the same shape: entity rows [emb d | adagrad d] of 256 f32
# and relation rows [emb d^2 | adagrad d^2] of 32,768 f32, two length
# classes, so one K1 and one K3 per class a step and one K16
L_ENT_RESCAL, L_REL_RESCAL = 2 * D_MODEL, 2 * D_MODEL ** 2
RESCAL_STEP_KERNELS = ("routed_gather", "rescal_step", "ordered_scatter_add")
RESCAL_KERNELS = RESCAL_STEP_KERNELS + ("pool_eval_counts",)
RESCAL_STEP_LAUNCHES = {"routed_gather": 2, "rescal_step": 1,
                        "adagrad_update": 0, "ordered_scatter_add": 2}
# a KGE step whose negatives are one [N] batch shared by its triples: no
# fused form takes it, so autograd and one K2 per trainable role
SHARED_NEG_KERNELS = ("routed_gather", "adagrad_update",
                      "ordered_scatter_add")
L = 4 * D_MODEL                       # [emb 2d | adagrad 2d]
ROWS = 3 * B + B * N                  # gathered rows per step: 143,360
ROLE_SPLIT = [B, B, B, B * N]         # the step's four roles, one class
# launches per main-path step (S=1, no replicas) and per replica step:
# one K1 and one K3 per pool per class, one K5 for the model math
STEP_LAUNCHES = {"routed_gather": 1, "complex_step": 1, "adagrad_update": 0,
                 "ordered_scatter_add": 1}
REPLICA_STEP_LAUNCHES = {"routed_gather": 1, "complex_step": 1,
                         "adagrad_update": 0, "ordered_scatter_add": 2}
STEPS, WARMUP = 32, 3
SCAN_K, SCAN_TIMED = 8, 4             # run_scan window, windows timed
PROF_STEPS = 8                        # phase 3 (pipeline): profiled steps
APP_STEPS1 = 64                       # phase 5's --scan_steps 1 runs
PULL_BATCHES = 64                     # phase 11: pull-driven batches
PLANNER_RUNS = 300                    # phase 12: pushes per worker thread
# phase 12's rounds/s in the last full run before K14 and K15 (NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md section 5): quoted beside this
# run's, not measured in it
PLANNER_ROUNDS_S_BEFORE = 124.2
# word2vec at bench.py bench_w2v's width: V words (keys 2w, 2w+1), rows
# [emb d | adagrad d], B pairs, N alias-drawn negatives per pair
V_W2V, D_W2V, B_W2V, N_W2V = 100_000, 128, 8192, 5
L_W2V = 2 * D_W2V
W2V_ROWS = 2 * B_W2V + B_W2V * N_W2V      # gathered rows per step: 57,344
W2V_LR = 0.05                             # bench_w2v's
# matrix factorization at rank 128 on a MovieLens-1M-sized matrix
# (6,040 x 3,706, 1,000,209 ratings), synthetic low-rank values
MF_ROWS, MF_COLS, MF_NNZ, MF_RANK, B_MF = 6_040, 3_706, 1_000_209, 128, 8192
W2V_KERNELS = ("routed_gather", "sgns_step", "ordered_scatter_add")
MF_KERNELS = ("routed_gather", "mf_step", "ordered_scatter_add")
# the step kernels that compute model math: a path launches its own and
# none of the others
MODEL_KERNELS = ("adagrad_update", "complex_step", "sgns_step", "mf_step",
                 "rescal_step")
W2V_STEP_LAUNCHES = {"routed_gather": 1, "sgns_step": 1,
                     "adagrad_update": 0, "ordered_scatter_add": 1}
# kernels that belong to one path: a path launches its own and none of
# the others' (the model math, and K8, the bag read of phase 10)
OWNED_KERNELS = MODEL_KERNELS + ("gather_pool", "gather_cold",
                                 "gather_pool_cold", "write_main_rows",
                                 "sync_compress", "alltoall_put",
                                 "pool_eval_dist")
# the bag-serving shape of the MLPerf Training DLRM-DCNv2 reference
# (recommendation_v2/torchrec_dcn, Criteo 1TB multi-hot): 26 sparse
# features of embedding dim 128 with these cardinalities and multi-hot
# sizes (214 members a sample), each table cut to DLRM_CAP rows (204M
# rows of 1 KB do not fit on one card: 7,116,632 keys), rows
# [emb 128 | adagrad 128]
DLRM_CARDS = (40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63,
              40000000, 3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14,
              40000000, 40000000, 40000000, 590152, 12973, 108, 36)
DLRM_HOTS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
             100, 27, 10, 3, 1, 1)
DLRM_CAP, DLRM_SAMPLES, L_DLRM = 1_000_000, 32, 256
K8_REQUESTS = 64              # one coalesced batch (--sys.serve.max_batch)
# K8's trace ms before its redesign (one warp a bag), per batch of
# requests, as measured by this script's phase 2 on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md section 6); quoted beside this run's times, not
# measured in it
K8_PRIOR_MS = {8: 0.0547, 64: 0.2341}
# phase 10 (b) and 13 (c): clients x requests (requests cut from 50 to
# 25 to fit the RESCAL lines in the run's time: the segments' samples/s
# and p50/p99 are settled since the bag path's redesign)
BAG_CLIENTS, BAG_REQUESTS = 8, 25
# phase 10 (a) and 14 (d): clients x lookups (lookups cut from 100 to 50
# to fit the RESCAL lines: the flat segments' numbers are settled)
SERVE_CLIENTS, SERVE_LOOKUPS = 32, 50
# phase 13 and K9-K12's phase-2 shapes: the tiered KGE table's hot rows
# per shard, the tiered DLRM table's, rows a promotion batch uploads,
# replica rows a compressed round takes, the full-width storm's ops, and
# EpisodicRunner's steps and episode length
TIER_HOT, TIER_BAG_HOT = 65_536, 1_048_576
TIER_PROMOTED, TIER_SYNC_ROWS = 16_384, 65_536
# K3 at the main path's rows before its fold took column slabs, as
# measured by this script's phase 2 on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md section 6): quoted beside this run's, not measured in it
K3_PRIOR_MS = 0.3138
# K15's heavy round: owner rows named this many times in one round
K15_HOT = 1000
TIER_STORM_OPS, EPISODE_STEPS, EPISODE_B = 24, 16, 8
HBM_BYTES_PER_S = 3.35e12             # H100 SXM
F32_FLOPS = 67e12                     # H100 SXM, outside the tensor cores
# H100 SXM square roots on the SFU: 16 results a clock an SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute
# capability 9.0), 132 SMs at the 1.98 GHz boost clock
SFU_PER_S = 132 * 16 * 1.98e9


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def skewed_keys(rng, n, size):
    """Power-law key skew (the JAX package's bench._skewed_keys)."""
    return (n * rng.random(size) ** 3).astype(np.int64).clip(0, n - 1)


def cuda_ms(fn, reps=20, warmup=3):
    """Milliseconds of fn() per launch over `reps` launches, each between
    its own pair of CUDA events: (median, min, max)."""
    for _ in range(warmup):
        fn()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in evs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    t = np.array([a.elapsed_time(b) for a, b in evs])
    return float(np.median(t)), float(t.min()), float(t.max())


def kernel_ms(fn, kernel, reps=20, warmup=3, between=None, per_call=1):
    """The profiler's view of `reps` calls of fn(): the device
    milliseconds of each launch of the kernel whose name contains
    `kernel` (summed over the `per_call` such records one call makes),
    as (median, min, max), and the device milliseconds per call of
    everything the calls ran. For a kernel shorter than its
    wrapper's host time, CUDA events around each call (cuda_ms) measure
    the host's launch gap as well; the trace measures the kernel alone.
    `between()` runs before each call (e.g. an L2 flush). A trace that
    lost a launch's record (seen once in about 150 traces of one
    process, and for K7's 9 µs launches three traces in a row) is taken
    again, up to four times; TRACE_RETAKES counts those retakes by
    kernel, and the run prints it."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    for attempt in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if between is not None:
                    between()
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in evs) / 1e3 / reps
        if kernel is None:
            # calls that launch the same work leave a whole number of
            # records a call, or the trace lost some
            if (evs and len(evs) % reps == 0) or attempt == 4:
                return None, total
        else:
            mine = np.array([e.self_device_time_total for e in evs
                             if kernel in e.name]) / 1e3
            if len(mine) == reps * per_call:
                break
        TRACE_RETAKES[kernel] = TRACE_RETAKES.get(kernel, 0) + 1
    check(len(mine) == reps * per_call, f"the trace holds {len(mine)} "
          f"launches of {kernel}, expected {reps * per_call}")
    mine = mine.reshape(reps, per_call).sum(axis=1)
    return (float(np.median(mine)), float(mine.min()),
            float(mine.max())), total


TRACE_RETAKES = {}


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_breakdown(step, n):
    """Device time of `n` calls of step() by kernel name (torch.profiler,
    CUDA activity), the wall time, and the share of it the device was
    busy. Returns None when the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, counts = {}, {}
    launches = 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_name[ev.key] = by_name.get(ev.key, 0.0) + \
            ev.self_device_time_total / 1e3
        label = _kernel_label(ev.key)
        counts[label] = counts.get(label, 0) + ev.count
        launches += ev.count
    busy_ms = sum(by_name.values())
    if busy_ms <= 0:
        return None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(wall_ms_per_step=wall_ms / n, device_ms_per_step=busy_ms / n,
                busy_share=busy_ms / wall_ms,
                device_ops_per_step=launches / n, counts=counts,
                top_ms_per_step=[(_kernel_label(k), v / n) for k, v in top])


def _kernel_label(name):
    """Short label of a CUDA kernel name: the innermost functor of a
    PyTorch elementwise/reduce kernel, else the kernel's own name."""
    import re
    functors = re.findall(r"\w*(?:Functor|_functor)\w*", name)
    head = name.replace("(anonymous namespace)::", "").replace("void ", "")
    head = head.split("(")[0].split("<")[0].split("::")[-1]
    return f"{head}[{functors[-1]}]" if functors else head


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def step_keys(dev, rng):
    """The main path's pool (E + R rows of L f32 at the store's rule) and
    one step's ROWS coordinates into it: zipf subjects and objects,
    uniform relations and negatives."""
    slots = -8 * (-int(np.ceil((E + R) * 1.25)) // 8)    # the store's rule
    main = torch.randn((1, slots, L), device=dev)
    main[0, :4] = -0.0
    keys = np.concatenate([skewed_keys(rng, E, B), rng.integers(E, E + R, B),
                           skewed_keys(rng, E, B),
                           rng.integers(0, E, B * N)])
    o_sh = torch.zeros(ROWS, dtype=torch.int32, device=dev)
    o_sl = torch.as_tensor(keys.astype(np.int32), device=dev)
    return main, o_sh, o_sl


def k1_slab(K, n, L, rows):
    """K1's column slab in f32 columns for n rows of L f32 from pools of
    `rows` rows (L: whole rows), or None for an earlier tree's kernel,
    which walks whole rows with no plan."""
    slab = getattr(K, "_k1_slab", None)
    return None if slab is None else slab(n, L, rows, L % 4 == 0)


def phase_k1(K, dev, main, o_sh, o_sl):
    """K1 at the fused step's 143,360 rows of 512 f32: the main-only form
    (the no-replica step's read), the cache+delta form and the
    multi-segment forms at the step's four-role split, each bitwise its
    plain version; timed between CUDA events and in the trace, beside
    index_select."""
    got = K.routed_gather(main, None, None, o_sh, o_sl)
    ref = K.routed_gather_plain(main, None, None, o_sh, o_sl)
    check(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
          "K1 main-only form differs from its plain version")
    # full form: replica rows from cache+delta for 30% of the entries
    cslots = 16_384
    cache = torch.randn((1, cslots, L), device=dev)
    delta = torch.randn((1, cslots, L), device=dev)
    c_sl = torch.randint(0, cslots, (ROWS,), device=dev, dtype=torch.int32)
    c_sl[::97] = 2**31 - 2
    use_c = torch.rand(ROWS, device=dev) < 0.3
    full = (main, cache, delta, o_sh, o_sl, o_sh, c_sl, use_c)
    got_f = K.routed_gather(*full)
    ref_f = K.routed_gather_plain(*full)
    check(torch.equal(got_f.view(torch.int32), ref_f.view(torch.int32)),
          "K1 cache+delta form differs from its plain version")
    # multi-segment forms at the step's four-role split, one launch each
    for pools, cols in (((main, None, None), (o_sh, o_sl)),
                        ((main, cache, delta), full[3:])):
        segs = list(zip(*[c.split(ROLE_SPLIT) for c in cols]))
        segs = [tuple(t.contiguous() for t in s) for s in segs]
        got_s = K.routed_gather_segments(*pools, segs)
        ref_s = K.routed_gather_segments_plain(*pools, segs)
        check(torch.equal(got_s.view(torch.int32), ref_s.view(torch.int32)),
              f"K1 multi-segment form ({len(cols)} coordinate arrays) "
              "differs from its plain version")
    del cache, delta, got_f, ref_f
    n_main = int(torch.unique(o_sl.long()).numel())
    k1_bytes = n_main * L * 4 + ROWS * 4 * 2 + ROWS * L * 4
    flat = o_sl.long()
    mflat = main.view(-1, L)

    def k1():
        return K.routed_gather(main, None, None, o_sh, o_sl)

    def lib():
        return mflat.index_select(0, flat)

    return timed(
        max_abs_err=float((got - ref).abs().max()), ms=cuda_ms(k1),
        plain_ms=cuda_ms(
            lambda: K.routed_gather_plain(main, None, None, o_sh, o_sl)),
        library_ms=cuda_ms(lib), bound=bound(k1_bytes, 0),
        kernel_ms=kernel_ms(k1, "routed_gather_kernel")[0],
        library_kernel_ms=kernel_ms(lib, None)[1],
        slab_f32=k1_slab(K, ROWS, L, main.shape[0] * main.shape[1]))


def k1_wide(K, dev, rel, r_sh, r_sl, n_rel):
    """K1 at rows of 32,768 f32 (RESCAL's relation rows, 4,096 rows
    naming about 1,000 relations uniformly): the main-only form timed
    between CUDA events and in the trace beside index_select; the
    cache+delta form (30% of the rows from cache+delta) and the 4-byte
    form (rows of 32,766 f32) bitwise their plain versions too, timed in
    the trace."""
    n, Lr = r_sl.numel(), rel.shape[-1]
    rows = rel.shape[0] * rel.shape[1]
    flat, rflat = r_sl.long(), rel.view(-1, Lr)

    def k1():
        return K.routed_gather(rel, None, None, r_sh, r_sl)

    def lib():
        return rflat.index_select(0, flat)

    check(torch.equal(k1().view(torch.int32), K.routed_gather_plain(
        rel, None, None, r_sh, r_sl).view(torch.int32)),
        f"K1 at rows of {Lr} f32 differs from its plain version")
    cache, delta = torch.randn_like(rel), torch.randn_like(rel)
    c_sl = torch.randint(0, rel.shape[1], (n,), device=dev,
                         dtype=torch.int32)
    c_sl[::97] = 2**31 - 2
    use_c = torch.rand(n, device=dev) < 0.3
    full = (rel, cache, delta, r_sh, r_sl, r_sh, c_sl, use_c)
    check(torch.equal(K.routed_gather(*full).view(torch.int32),
                      K.routed_gather_plain(*full).view(torch.int32)),
          f"K1's cache+delta form at rows of {Lr} f32 differs from its "
          "plain version")
    full_ms = kernel_ms(lambda: K.routed_gather(*full),
                        "routed_gather_kernel")[0]
    # the full form's distinct rows: main rows of the main reads, cache
    # and delta rows of the others (OOB ones read nothing)
    ok = (c_sl >= 0) & (c_sl < rel.shape[1])
    n_full = int(torch.unique(r_sl[~use_c]).numel()) + 2 * int(
        torch.unique(c_sl[use_c & ok]).numel())
    del cache, delta
    narrow = rel[..., :Lr - 2].contiguous()
    check(torch.equal(K.routed_gather(narrow, None, None, r_sh, r_sl)
                      .view(torch.int32), K.routed_gather_plain(
                          narrow, None, None, r_sh, r_sl)
                      .view(torch.int32)),
          f"K1's 4-byte form at rows of {Lr - 2} f32 differs from its "
          "plain version")
    f32_ms = kernel_ms(lambda: K.routed_gather(narrow, None, None, r_sh,
                                               r_sl),
                       "routed_gather_kernel")[0]
    del narrow
    # floors on the same bytes: fill_ of the output alone, and K1 with
    # every row naming one pool row (the writes with no reads to speak of)
    out = k1()
    fill_ms = kernel_ms(lambda: out.fill_(1.0), None)[1]
    one = torch.zeros_like(r_sl)
    one_ms = kernel_ms(lambda: K.routed_gather(rel, None, None, r_sh, one),
                       "routed_gather_kernel")[0]
    del out
    torch.cuda.empty_cache()
    return dict(
        k1_ms=cuda_ms(k1), k1_kernel_ms=kernel_ms(
            k1, "routed_gather_kernel")[0],
        k1_fill_kernel_ms=fill_ms, k1_one_row_kernel_ms=one_ms,
        k1_library_ms=cuda_ms(lib),
        k1_library_kernel_ms=kernel_ms(lib, None)[1],
        k1_bound=bound(n_rel * Lr * 4 + n * 8 + n * Lr * 4, 0),
        k1_full_kernel_ms=full_ms,
        k1_full_bound=bound(n_full * Lr * 4 + n * 17 + n * Lr * 4, 0),
        k1_f32_kernel_ms=f32_ms,
        k1_slab=k1_slab(K, n, Lr, rows),
        k1_slab_full=k1_slab(K, n, Lr, 3 * rows),
        k1_slab_f32=k1_slab(K, n, Lr - 2, rows))


def report_k1_wide(w):
    """K1's phase-2 line at the relation rows' width."""
    print(f"phase 2: K1 at {w['rows']} rows of {w['width']:,} f32 "
          f"({w['distinct']} distinct relations), main-only, cache+delta "
          f"and 4-byte ({w['width'] - 2:,} f32) forms bitwise their plain "
          f"versions: {fmt_s(*w['k1_ms'])} ms between events, "
          f"{fmt_s(*w['k1_kernel_ms'])} in the trace (bound "
          f"{w['k1_bound'][0]:.4f} ms, share "
          f"{w['k1_bound'][0] / w['k1_kernel_ms'][0]:.3f}); index_select "
          f"{fmt_s(*w['k1_library_ms'])} between events, "
          f"{w['k1_library_kernel_ms']:.4f} in the trace; cache+delta "
          f"{fmt_s(*w['k1_full_kernel_ms'])} in the trace (bound "
          f"{w['k1_full_bound'][0]:.4f}), 4-byte "
          f"{fmt_s(*w['k1_f32_kernel_ms'])}; slab (f32) {w['k1_slab']}, "
          f"cache+delta {w['k1_slab_full']}, 4-byte {w['k1_slab_f32']}; "
          f"floors: fill_ of the output {w['k1_fill_kernel_ms']:.4f}, "
          f"every row naming one pool row "
          f"{fmt_s(*w['k1_one_row_kernel_ms'])}",
          flush=True)


def phase_k1_alone(K, dev, rng):
    """K1's phase-2 parts alone: at the fused step's rows (phase_k1) and
    at RESCAL's relation rows (k1_wide, on the pool phase_k16 makes)."""
    main, o_sh, o_sl = step_keys(dev, rng)
    narrow = phase_k1(K, dev, main, o_sh, o_sl)
    del main
    torch.cuda.empty_cache()
    rel = relation_pool(dev)
    rkeys = rng.integers(0, R, B)
    r_sh = torch.zeros(B, dtype=torch.int32, device=dev)
    r_sl = torch.as_tensor(rkeys.astype(np.int32), device=dev)
    w = k1_wide(K, dev, rel, r_sh, r_sl, len(np.unique(rkeys)))
    w.update(rows=B, width=rel.shape[-1], distinct=len(np.unique(rkeys)))
    return narrow, w


def report_k1_alone(r):
    narrow, w = r
    print(f"phase 2: K1 at {ROWS} rows of {L} f32: {fmt_t(narrow, 'ms')} "
          f"ms between events, {fmt_s(*narrow['kernel_ms'])} in the trace "
          f"(bound {narrow['bound'][0]:.4f} ms); index_select "
          f"{fmt_t(narrow, 'library_ms')} between events, "
          f"{narrow['library_kernel_ms']:.4f} in the trace; slab (f32) "
          f"{narrow['slab_f32']}", flush=True)
    report_k1_wide(w)


def phase_kernels(K, dev, rng):
    """Phase 2: each kernel against its plain version, timed."""
    rec = {}
    main, o_sh, o_sl = step_keys(dev, rng)

    rec["routed_gather"] = phase_k1(K, dev, main, o_sh, o_sl)

    rec["ordered_scatter_add"] = phase_k3(K, dev, main, o_sh, o_sl)

    # -- K2 adagrad_update on the gathered rows' accumulator half
    Dh = L // 2
    g = torch.randn((ROWS, Dh), device=dev)
    rows = torch.rand((ROWS, L), device=dev)
    acc = rows[:, Dh:]
    got2 = K.adagrad_update(g, acc, 0.1, 1e-10)
    ref2 = K.adagrad_update_plain(g, acc, 0.1, 1e-10)
    check(torch.allclose(got2, ref2, rtol=1e-5, atol=1e-7),
          "K2 differs from its plain version beyond rtol 1e-5 / atol 1e-7")
    # the fused step's form: (lr, eps) read from the device
    dev2 = K.adagrad_update(g, acc, lr_eps=torch.tensor([0.1, 1e-10],
                                                        device=dev))
    check(torch.equal(dev2.view(torch.int32), got2.view(torch.int32)),
          "K2 reading (lr, eps) from the device differs from K2 taking "
          "them as arguments")
    emb_a, acc_a = K.adagrad_apply(g, rows[:, :Dh].contiguous(),
                                   acc.contiguous(), 0.1, 1e-10)
    emb_r, acc_r = K.adagrad_apply_plain(g, rows[:, :Dh], acc, 0.1, 1e-10)
    check(torch.allclose(acc_a, acc_r, rtol=1e-5)
          and torch.allclose(emb_a, emb_r, rtol=1e-4, atol=1e-6),
          "K2 standalone form differs beyond the Pallas test's tolerance")
    k2_bytes = ROWS * Dh * 4 * 2 + ROWS * L * 4
    lib_ms = None
    fused = getattr(torch, "_fused_adagrad_", None)
    if fused is not None:
        # yardstick only: PyTorch's fused AdaGrad over the same rows
        p, s_ = rows[:, :Dh].contiguous(), acc.contiguous()
        step = [torch.zeros((), device=dev)]
        lib_ms = cuda_ms(lambda: fused([p], [g], [s_], step, lr=0.1,
                                       lr_decay=0.0, weight_decay=0.0,
                                       eps=1e-10, maximize=False))
    rec["adagrad_update"] = timed(
        max_abs_err=float((got2 - ref2).abs().max()),
        ms=cuda_ms(lambda: K.adagrad_update(g, acc, 0.1, 1e-10)),
        plain_ms=cuda_ms(lambda: K.adagrad_update_plain(g, acc, 0.1, 1e-10)),
        library_ms=lib_ms, bound=bound(k2_bytes, ROWS * Dh * 7))
    del main, g, rows
    torch.cuda.empty_cache()
    rec["pool_eval_counts"] = phase_k4(K, dev, rng)
    torch.cuda.empty_cache()
    rec["pool_eval_counts"]["mp_form"] = phase_k4_mp(K, dev, rng)
    torch.cuda.empty_cache()
    rec["complex_step"] = phase_k5(K, dev, rng)
    torch.cuda.empty_cache()
    rec["rescal_step"] = phase_k16(K, dev, rng)
    torch.cuda.empty_cache()
    rec["sgns_step"] = phase_k6(K, dev, rng)
    torch.cuda.empty_cache()
    rec["mf_step"] = phase_k7(K, dev, rng)
    torch.cuda.empty_cache()
    rec["gather_pool"] = phase_k8(K, dev, rng)
    torch.cuda.empty_cache()
    for name, run in (("gather_cold", phase_k9),
                      ("gather_pool_cold", phase_k10),
                      ("write_main_rows", phase_k11),
                      ("sync_compress", phase_k12)):
        rec[name] = run(K, dev, rng)
        torch.cuda.empty_cache()
    rec["alltoall_put"] = phase_k13(K, dev, rng)
    torch.cuda.empty_cache()
    rec["drop_set"] = phase_k14(K, dev, rng)
    torch.cuda.empty_cache()
    rec["sync_round"] = phase_k15(K, dev, rng)
    torch.cuda.empty_cache()
    rec["pool_eval_dist"] = phase_k17(K, dev, rng)
    torch.cuda.empty_cache()
    return rec


def phase_k3(K, dev, main, o_sh, o_sl):
    """Phase 2, K3 at the main path's rows (512 f32) and keys (zipf
    duplicates): bitwise its plain version and over two runs, its
    multi-segment form at the step's four-role split; timed whole, its
    fold and its ordering pass apart, and on uniform keys."""
    n_main = int(torch.unique(o_sl.long()).numel())
    flat = o_sl.long()
    vals = torch.randn((ROWS, L), device=dev)
    outs = []
    for _ in range(2):
        pool = main.clone()
        K.ordered_scatter_add(pool, o_sh, o_sl, vals)
        outs.append(pool)
    ref_pool = main.clone()
    K.ordered_scatter_add_plain(ref_pool, o_sh, o_sl, vals)
    check(torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32)),
          "K3 is not deterministic from run to run")
    check(torch.equal(outs[0].view(torch.int32), ref_pool.view(torch.int32)),
          "K3 differs from its plain version (np.add.at order)")
    err3 = float((outs[0] - ref_pool).abs().max())
    # the multi-segment form at the step's four-role split, one launch
    segs = [(a.contiguous(), b.contiguous()) for a, b in
            zip(o_sh.split(ROLE_SPLIT), o_sl.split(ROLE_SPLIT))]
    pool = main.clone()
    K.ordered_scatter_add_segments(pool, segs, vals)
    check(torch.equal(pool.view(torch.int32), ref_pool.view(torch.int32)),
          "K3 multi-segment form differs from its plain version")
    del outs, ref_pool, pool
    scratch = main.clone()
    k3_bytes = ROWS * L * 4 + 2 * n_main * L * 4 + ROWS * 4 * 2
    # the fold alone reads the sorted int32 targets and the int64
    # permutation instead of the coordinates
    fold_bytes = ROWS * L * 4 + 2 * n_main * L * 4 + ROWS * (4 + 8)
    sf, perm = K.ordered_scatter_order(scratch, [(o_sh, o_sl)])
    flat32 = sf.clone()[torch.argsort(perm)]      # unsorted int32 targets
    longest = int(torch.unique_consecutive(sf, return_counts=True)[1].max())
    # uniform keys of the same n: the gap to the zipf time is the tail
    u_sl = torch.randint(0, E + R, (ROWS,), device=dev, dtype=torch.int32)
    u_sf, _ = K.ordered_scatter_order(scratch, [(o_sh, u_sl)])
    u_longest = int(torch.unique_consecutive(u_sf,
                                             return_counts=True)[1].max())
    u_main = int(torch.unique(u_sl).numel())
    return timed(
        max_abs_err=err3,
        ms=cuda_ms(lambda: K.ordered_scatter_add(scratch, o_sh, o_sl, vals)),
        plain_ms=cuda_ms(lambda: K.ordered_scatter_add_plain(
            scratch, o_sh, o_sl, vals), warmup=1),
        library_ms=cuda_ms(lambda: scratch.view(-1, L).index_add_(
            0, flat, vals)),
        bound=bound(k3_bytes, ROWS * L),
        fold_ms=cuda_ms(lambda: K.ordered_scatter_fold(scratch, sf, perm,
                                                       vals)),
        fold_bound=bound(fold_bytes, ROWS * L),
        order_ms=cuda_ms(lambda: K.ordered_scatter_order(
            scratch, [(o_sh, o_sl)])),
        sort_ms=cuda_ms(lambda: torch.sort(flat32, stable=True)),
        uniform_ms=cuda_ms(lambda: K.ordered_scatter_add(
            scratch, o_sh, u_sl, vals)),
        uniform_bound=bound(ROWS * L * 4 + 2 * u_main * L * 4 + ROWS * 8,
                            ROWS * L),
        longest_run=longest, uniform_longest_run=u_longest,
        grid=fold_grid(K, ROWS, L), ptxas=ptxas_summary("ordered_scatter"))


def fold_grid(K, n, width):
    """K3's fold grid for n entries of `width` f32 on this card: CTAs
    along the entries, column slabs, column blocks a slab, ring depth,
    shared bytes a CTA."""
    lib = K._lib("ordered_scatter")
    if not hasattr(lib, "adapm_ordered_fold_grid"):
        return None                       # an earlier tree's fold
    out = (ctypes.c_int * 5)()
    check(lib.adapm_ordered_fold_grid(n, width, int(width % 4 == 0),
                                      out) == 0, "K3's fold grid failed")
    return dict(zip(("ctas", "slabs", "blocks_a_slab", "stages", "smem"),
                    out))


def check_k67(K, name, got, got2, plain, grads, rows, d, form):
    """K6/K7 against the plain version (loss and update rows within rtol
    1e-5 / atol 1e-6), against itself over two runs (bitwise), and K2 on
    its gradient output against its update rows (bitwise). Returns the
    largest absolute error."""
    (l1, u1), (l2_, u2), (lp, up) = got, got2, plain
    torch.cuda.synchronize()
    check(torch.equal(l1.view(torch.int32), l2_.view(torch.int32))
          and all(torch.equal(u1[k].view(torch.int32),
                              u2[k].view(torch.int32)) for k in u1),
          f"{name} ({form}) is not deterministic from run to run")
    err = float((l1 - lp).abs().max())
    check(torch.allclose(l1, lp, rtol=1e-5, atol=1e-6),
          f"{name} ({form}) loss differs from its plain version beyond "
          f"rtol 1e-5 / atol 1e-6 (max {err})")
    for k in u1:
        e = float((u1[k] - up[k]).abs().max())
        check(torch.allclose(u1[k], up[k], rtol=1e-5, atol=1e-6),
              f"{name} ({form}) update rows of {k} differ from the plain "
              f"version beyond rtol 1e-5 / atol 1e-6 (max {e})")
        acc = rows[k].reshape(-1, 2 * d)[:, d:]
        k2 = K.adagrad_update(grads[k], acc, 0.1, 1e-10)
        check(torch.equal(k2.view(torch.int32), u1[k].view(torch.int32)),
              f"K2 on {name}'s gradient of {k} differs from its update "
              "rows")
        err = max(err, e)
    return err


def step_rows(K, dev, nkeys, keys, L_, scale, seed):
    """The step's gathered rows [emb | acc] of L_ floats: K1's gather of a
    pool (values normal x `scale`, accumulators 1e-6 plus up to 1e-3) by
    the step's keys."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    slots = -8 * (-int(np.ceil(nkeys * 1.25)) // 8)   # the store's rule
    pool = torch.randn((1, slots, L_), device=dev, generator=g) * scale
    pool[..., L_ // 2:] = 1e-6 + torch.rand(
        (1, slots, L_ // 2), device=dev, generator=g) * 1e-3
    n = len(keys)
    return K.routed_gather(
        pool, None, None, torch.zeros(n, dtype=torch.int32, device=dev),
        torch.as_tensor(keys.astype(np.int32), device=dev))


def phase_k6(K, dev, rng):
    """K6 on the w2v step's rows at bench_w2v's width: zipf-skewed center
    and context keys, negatives drawn on the device from the unigram^0.75
    alias table (the runner's own draw), the rows viewed per role as the
    step views them."""
    from adapm_tpu_torch.models.sgns import (build_alias_table, sgns_loss,
                                             syn1_key)
    from adapm_tpu_torch.ops import fused
    d = D_W2V
    prob, alias = build_alias_table(1.0 / (np.arange(V_W2V) + 10.0))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    neg = fused._draw_negatives(
        (B_W2V, N_W2V), None,
        (torch.as_tensor(prob, device=dev), torch.as_tensor(alias,
                                                            device=dev),
         torch.as_tensor(syn1_key(np.arange(V_W2V)).astype(np.int32),
                         device=dev)), gen)
    keys = np.concatenate([2 * skewed_keys(rng, V_W2V, B_W2V),
                           2 * skewed_keys(rng, V_W2V, B_W2V) + 1,
                           neg.reshape(-1).cpu().numpy()])
    rows = step_rows(K, dev, 2 * V_W2V, keys, L_W2V, 0.05, 1)
    role = {"center": rows[:B_W2V], "ctx": rows[B_W2V:2 * B_W2V],
            "neg": rows[2 * B_W2V:].reshape(B_W2V, N_W2V, L_W2V)}
    args = (role["center"], role["ctx"], role["neg"])
    nrows = {"center": B_W2V, "ctx": B_W2V, "neg": B_W2V * N_W2V}
    lr_eps = torch.tensor([0.1, 1e-10], device=dev)

    def buffers(width):
        return {k: torch.empty((n, width), device=dev)
                for k, n in nrows.items()}

    def run(fn, grad=None):
        out = buffers(L_W2V)
        return fn(*args, lr_eps, out=out, grad_out=grad), out

    grads = buffers(d)
    err = check_k67(K, "K6", run(K.sgns_step, grads), run(K.sgns_step),
                    run(K.sgns_step_plain), grads, role, d, "w2v")
    out = buffers(L_W2V)
    roles = sorted(role)

    def eager():
        # the parent's model math: autograd of the same loss, K2 per role
        # (the lambda hides the loss's fused form)
        return fused._loss_and_updates(
            lambda e, aux: sgns_loss(e, aux), role, dict.fromkeys(roles, d),
            roles, {0: roles}, None, lr_eps)

    # each gathered row read once, one update row written per row, the
    # [B] losses; flops: 1 + N dots and as many gradient terms of 2d per
    # pair, the epilogue (7 per value)
    flops = B_W2V * (N_W2V + 1) * 4 * d + W2V_ROWS * d * 7
    return timed_k67(
        dev, lambda: K.sgns_step(*args, lr_eps, out=out), "sgns_step_kernel",
        lambda: K.sgns_step_plain(*args, lr_eps, out=out), eager,
        max_abs_err=err,
        bound=bound(2 * W2V_ROWS * L_W2V * 4 + B_W2V * 4, flops),
        ptxas=ptxas_summary("sgns_step"),
        unique_rows=int(np.unique(keys).size))


def timed_k67(dev, kern, name, plain, eager, **kw):
    """A K6/K7 record: `ms` is the kernel's device time from the trace
    (kernel_ms), as the step finds its inputs (K1 has just written them:
    hot in L2 where they fit), `cold_ms` the same after writing 256 MB
    between launches (L2 cold), `call_ms` the wrapper call between CUDA
    events; the plain version and the parent's eager path between CUDA
    events (as they run: host-bound where their launches are short),
    with their device time per call beside."""
    k_ms, _ = kernel_ms(kern, name)
    flush = torch.empty(64 << 20, device=dev)
    cold, _ = kernel_ms(kern, name, between=flush.zero_)
    del flush
    kw["cold_ms"] = cold
    _, plain_dev = kernel_ms(plain, None, reps=5, warmup=1)
    _, eager_dev = kernel_ms(eager, None, reps=5, warmup=1)
    return timed(ms=k_ms, plain_ms=cuda_ms(plain), library_ms=None,
                 call_ms=cuda_ms(kern), eager_ms=cuda_ms(eager),
                 plain_device_ms=plain_dev, eager_device_ms=eager_dev, **kw)


def phase_k7(K, dev, rng):
    """K7 on the MF step's rows: B ratings of the MovieLens-1M-sized
    matrix (uniform row and column keys, as the synthetic generator
    draws them), rank 128, with l2 in {0, 0.01}."""
    from adapm_tpu_torch.models.mf import make_mf_loss
    from adapm_tpu_torch.ops import fused
    d = MF_RANK
    keys = np.concatenate([rng.integers(0, MF_ROWS, B_MF),
                           rng.integers(MF_ROWS, MF_ROWS + MF_COLS, B_MF)])
    rows = step_rows(K, dev, MF_ROWS + MF_COLS, keys, 2 * MF_RANK, 0.1,
                     2)
    role = {"w": rows[:B_MF], "h": rows[B_MF:]}
    x = torch.randn(B_MF, device=dev)
    lr_eps = torch.tensor([0.1, 1e-10], device=dev)

    def buffers(width):
        return {k: torch.empty((B_MF, width), device=dev) for k in role}

    forms, err = {}, 0.0
    for l2 in (0.0, 0.01):
        def run(fn, grad=None):
            out = buffers(2 * d)
            return fn(role["w"], role["h"], x, lr_eps, l2, out=out,
                      grad_out=grad), out
        grads = buffers(d)
        forms[f"l2={l2}"] = check_k67(
            K, "K7", run(K.mf_step, grads), run(K.mf_step),
            run(K.mf_step_plain), grads, role, d, f"l2={l2}")
        err = max(err, forms[f"l2={l2}"])
    out = buffers(2 * d)
    loss_fn = make_mf_loss(0.01)

    def eager():
        return fused._loss_and_updates(
            lambda e, aux: loss_fn(e, aux), role, dict.fromkeys(role, d),
            ["h", "w"], {0: ["h", "w"]}, x, lr_eps)

    flops = B_MF * 3 * 2 * d * 2 + 2 * B_MF * d * 7
    return timed_k67(
        dev,
        lambda: K.mf_step(role["w"], role["h"], x, lr_eps, 0.01, out=out),
        "mf_step_kernel",
        lambda: K.mf_step_plain(role["w"], role["h"], x, lr_eps, 0.01,
                                out=out), eager,
        max_abs_err=err, forms=forms,
        bound=bound(2 * 2 * B_MF * 2 * d * 4 + 2 * B_MF * 4, flops),
        ptxas=ptxas_summary("mf_step"))


def phase_k5(K, dev, rng):
    """K5 against its plain version on the step's rows: K1's gather of a
    pool (the app's init scale, accumulators 1e-6 plus up to 1e-3) by the
    step's zipf-skewed keys, viewed per role as the step views them."""
    from adapm_tpu_torch.models import make_kge_loss
    from adapm_tpu_torch.ops import fused
    Dh = 2 * D_MODEL
    slots = -8 * (-int(np.ceil((E + R) * 1.25)) // 8)
    pool = torch.randn((1, slots, L), device=dev) * 0.1
    pool[..., Dh:] = 1e-6 + torch.rand((1, slots, Dh), device=dev) * 1e-3
    keys = np.concatenate([skewed_keys(rng, E, B), rng.integers(E, E + R, B),
                           skewed_keys(rng, E, B),
                           rng.integers(0, E, B * N)])
    rows = K.routed_gather(
        pool, None, None, torch.zeros(ROWS, dtype=torch.int32, device=dev),
        torch.as_tensor(keys.astype(np.int32), device=dev))
    del pool
    role = {"s": rows[:B], "r": rows[B:2 * B], "o": rows[2 * B:3 * B],
            "neg": rows[3 * B:].reshape(B, N, L)}
    args = (role["s"], role["r"], role["o"], role["neg"])
    nrows = {"s": B, "r": B, "o": B, "neg": B * N}
    lr_eps = torch.tensor([0.1, 1e-10], device=dev)

    def buffers(width):
        return {k: torch.empty((n, width), device=dev)
                for k, n in nrows.items()}

    err, forms = 0.0, {}
    for T, l2 in ((0.0, 0.0), (1.0, 0.0), (0.0, 0.1), (1.0, 0.1)):
        u1, u2, up, g1 = buffers(L), buffers(L), buffers(L), buffers(Dh)
        l1 = K.complex_step(*args, lr_eps, T, l2, out=u1, grad_out=g1)
        l2_ = K.complex_step(*args, lr_eps, T, l2, out=u2)
        lp = K.complex_step_plain(*args, lr_eps, T, l2, out=up)
        torch.cuda.synchronize()
        check(torch.equal(l1.view(torch.int32), l2_.view(torch.int32))
              and all(torch.equal(u1[k].view(torch.int32),
                                  u2[k].view(torch.int32)) for k in u1),
              f"K5 (T={T}, l2={l2}) is not deterministic from run to run")
        form_err = float((l1 - lp).abs().max())
        check(torch.allclose(l1, lp, rtol=1e-5, atol=1e-6),
              f"K5 (T={T}, l2={l2}) loss differs from its plain version "
              f"beyond rtol 1e-5 / atol 1e-6 (max {form_err})")
        for k in u1:
            e = float((u1[k] - up[k]).abs().max())
            check(torch.allclose(u1[k], up[k], rtol=1e-5, atol=1e-6),
                  f"K5 (T={T}, l2={l2}) update rows of {k} differ from the "
                  f"plain version beyond rtol 1e-5 / atol 1e-6 (max {e})")
            acc = role[k].reshape(-1, L)[:, Dh:]
            k2 = K.adagrad_update(g1[k], acc, 0.1, 1e-10)
            check(torch.equal(k2.view(torch.int32), u1[k].view(torch.int32)),
                  f"K2 on K5's gradient of {k} differs from K5's update rows")
            form_err = max(form_err, e)
        forms[f"T={T} l2={l2}"] = form_err
        err = max(err, form_err)
        del u1, u2, up, g1
    out = buffers(L)
    loss_fn = make_kge_loss("complex")
    roles = sorted(role)

    def eager():
        # the parent's model math: autograd of the same loss, K2 per role
        # (the lambda hides the loss's fused form)
        return fused._loss_and_updates(
            lambda e, aux: loss_fn(e, aux), role, dict.fromkeys(roles, Dh),
            roles, {0: roles}, None, lr_eps)

    # read every row once, write one update row per row; flops: the two
    # partials (8d), 2N+1 dots of 2d, NS and NO (8Nd), the gradients
    # (about 40d) and g_neg (4Nd) per triple, the epilogue (7 per value)
    flops = B * (8 * D_MODEL + (2 * N + 1) * 2 * Dh + 12 * N * D_MODEL
                 + 40 * D_MODEL) + ROWS * Dh * 7
    return timed(
        max_abs_err=err, forms=forms,
        ms=cuda_ms(lambda: K.complex_step(*args, lr_eps, out=out)),
        plain_ms=cuda_ms(lambda: K.complex_step_plain(*args, lr_eps,
                                                      out=out),
                         reps=5, warmup=1),
        library_ms=None, bound=bound(2 * ROWS * L * 4 + B * 4, flops),
        eager_ms=cuda_ms(eager, reps=10), ptxas=ptxas_summary("complex_step"))


def rescal_pool(dev, n, width):
    """A RESCAL pool of n keys (slots at the store's rule) of rows [emb
    width | adagrad width] at the app's init scale: normal x 0.1,
    accumulators 1e-6 plus up to 1e-3."""
    slots = -8 * (-int(np.ceil(n * 1.25)) // 8)
    p = torch.randn((1, slots, 2 * width), device=dev) * 0.1
    p[..., width:] = 1e-6 + torch.rand((1, slots, width), device=dev) * 1e-3
    return p


def relation_pool(dev):
    """RESCAL's relation pool: R keys of rows of 2 d^2 f32."""
    return rescal_pool(dev, R, D_MODEL ** 2)


def phase_k16(K, dev, rng):
    """K16 against its plain version on the RESCAL step's rows: K1's
    gathers of an entity pool (rows of 256 f32) and a relation pool (rows
    of 32,768 f32) at the app's init scale (normal x 0.1, accumulators
    1e-6 plus up to 1e-3) by zipf-skewed subject and object keys, uniform
    negatives and uniform relation keys, viewed per role as the step
    views them. First K1 and K3 at the relation rows' width, each bitwise
    its plain version (K3 also over two runs) and timed beside
    index_select and index_add_."""
    from adapm_tpu_torch.models import make_kge_loss
    from adapm_tpu_torch.ops import fused
    d, dd = D_MODEL, D_MODEL ** 2
    Lr = 2 * dd

    def coords(keys):
        return (torch.zeros(len(keys), dtype=torch.int32, device=dev),
                torch.as_tensor(keys.astype(np.int32), device=dev))

    ent, rel = rescal_pool(dev, E, d), relation_pool(dev)
    e_sh, e_sl = coords(np.concatenate([
        skewed_keys(rng, E, B), skewed_keys(rng, E, B),
        rng.integers(0, E, B * N)]))
    rkeys = rng.integers(0, R, B)
    r_sh, r_sl = coords(rkeys)
    erows = K.routed_gather(ent, None, None, e_sh, e_sl)
    rrows = K.routed_gather(rel, None, None, r_sh, r_sl)
    del ent
    # -- K1 and K3 at rows of 32,768 f32 (about 4 occurrences a relation)
    n_rel = len(np.unique(rkeys))
    wide = dict(rows=B, width=Lr, distinct=n_rel,
                **k1_wide(K, dev, rel, r_sh, r_sl, n_rel))
    vals = torch.randn((B, Lr), device=dev) * 1e-3
    outs = []
    for _ in range(2):
        p = rel.clone()
        K.ordered_scatter_add(p, r_sh, r_sl, vals)
        outs.append(p)
    p = rel.clone()
    K.ordered_scatter_add_plain(p, r_sh, r_sl, vals)
    check(torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
          and torch.equal(outs[0].view(torch.int32), p.view(torch.int32)),
          f"K3 at rows of {Lr} f32 differs from its plain version or "
          "from itself over two runs")
    del outs, p
    flat, rflat = r_sl.long(), rel.view(-1, Lr)
    sf, perm = K.ordered_scatter_order(rel, [(r_sh, r_sl)])
    wide.update(
        k3_grid=fold_grid(K, B, Lr),
        k3_ms=cuda_ms(lambda: K.ordered_scatter_add(rel, r_sh, r_sl, vals)),
        k3_fold_ms=cuda_ms(lambda: K.ordered_scatter_fold(rel, sf, perm,
                                                          vals)),
        k3_library_ms=cuda_ms(lambda: rflat.index_add_(0, flat, vals)),
        k3_bound=bound(B * Lr * 4 + 2 * n_rel * Lr * 4 + B * 8, B * Lr))
    del rel, vals, rflat, sf, perm
    torch.cuda.empty_cache()

    role = {"s": erows[:B], "r": rrows, "o": erows[B:2 * B],
            "neg": erows[2 * B:].reshape(B, N, 2 * d)}
    args = (role["s"], role["r"], role["o"], role["neg"])
    nrows = {"s": B, "r": B, "o": B, "neg": B * N}
    width = {"s": d, "r": dd, "o": d, "neg": d}
    lr_eps = torch.tensor([0.1, 1e-10], device=dev)

    def buffers(f):
        return {k: torch.empty((n, f * width[k]), device=dev)
                for k, n in nrows.items()}

    err, forms = 0.0, {}
    for T, l2 in ((0.0, 0.0), (1.0, 0.0), (0.0, 0.1), (1.0, 0.1)):
        u1, u2, up, g1 = buffers(2), buffers(2), buffers(2), buffers(1)
        l1 = K.rescal_step(*args, lr_eps, T, l2, out=u1, grad_out=g1)
        l2_ = K.rescal_step(*args, lr_eps, T, l2, out=u2)
        lp = K.rescal_step_plain(*args, lr_eps, T, l2, out=up)
        torch.cuda.synchronize()
        check(torch.equal(l1.view(torch.int32), l2_.view(torch.int32))
              and all(torch.equal(u1[k].view(torch.int32),
                                  u2[k].view(torch.int32)) for k in u1),
              f"K16 (T={T}, l2={l2}) is not deterministic from run to run")
        form_err = float((l1 - lp).abs().max())
        check(torch.allclose(l1, lp, rtol=1e-5, atol=1e-6),
              f"K16 (T={T}, l2={l2}) loss differs from its plain version "
              f"beyond rtol 1e-5 / atol 1e-6 (max {form_err})")
        for k in u1:
            e = float((u1[k] - up[k]).abs().max())
            check(torch.allclose(u1[k], up[k], rtol=1e-5, atol=1e-6),
                  f"K16 (T={T}, l2={l2}) update rows of {k} differ from the "
                  f"plain version beyond rtol 1e-5 / atol 1e-6 (max {e})")
            w = width[k]
            k2 = K.adagrad_update(g1[k], role[k].reshape(-1, 2 * w)[:, w:],
                                  0.1, 1e-10)
            check(torch.equal(k2.view(torch.int32), u1[k].view(torch.int32)),
                  f"K2 on K16's gradient of {k} differs from K16's update "
                  "rows")
            form_err = max(form_err, e)
        forms[f"T={T} l2={l2}"] = form_err
        err = max(err, form_err)
        del u1, u2, up, g1
    out = buffers(2)
    loss_fn = make_kge_loss("rescal")

    def eager():
        # the parent's model math: autograd of the same loss (the
        # score's einsum), K2 per role (the lambda hides the fused form)
        return fused._loss_and_updates(
            lambda e, aux: loss_fn(e, aux), role, width, sorted(role),
            {0: ["neg", "o", "s"], 1: ["r"]}, None, lr_eps)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eager()
    torch.cuda.synchronize()
    eager_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    eager_ms = cuda_ms(eager, reps=3, warmup=1)
    torch.cuda.empty_cache()
    # read every row once, write one update row per row; flops per
    # triple: u, v, R y, R^T x (8 d^2), g_R (2 d^2), 2N + 1 dots of d,
    # x and y (4Nd), g_neg (3Nd), g_s and g_o (4d), the epilogue (7 per
    # value)
    nbytes = 2 * 4 * (2 * B * 2 * d + B * Lr + B * N * 2 * d) + B * 4
    flops = B * (10 * dd + (2 * N + 1) * 2 * d + 7 * N * d + 4 * d) \
        + 7 * B * (2 * d + dd + N * d)
    return timed(
        max_abs_err=err, forms=forms,
        ms=cuda_ms(lambda: K.rescal_step(*args, lr_eps, out=out)),
        plain_ms=cuda_ms(lambda: K.rescal_step_plain(*args, lr_eps,
                                                     out=out),
                         reps=5, warmup=1),
        library_ms=None, bound=bound(nbytes, flops), bytes=nbytes,
        eager_ms=eager_ms, eager_peak_gib=eager_peak,
        smem=int(K._lib("rescal_step").adapm_rescal_step_smem(N, d)),
        ptxas=ptxas_summary("rescal_step"), wide=wide)


def report_k16(r):
    """K16's phase-2 lines, and K1's and K3's at the relation rows'
    width."""
    w = r["wide"]
    print(f"phase 2: K16 at B={B}, N={N}, d={D_MODEL}: {fmt_t(r, 'ms')} ms "
          f"(bound {r['bound'][0]:.4f} ms, {r['bound'][1]}, "
          f"{r['bytes']:,} bytes; share {r['bound'][0] / r['ms']:.3f}); "
          f"the parent's eager model math (autograd + 4 K2) "
          f"{fmt_s(*r['eager_ms'])} ms, peak {r['eager_peak_gib']:.2f} GiB "
          f"above the rows; plain {fmt_t(r, 'plain_ms')} ms; max abs err "
          f"per (T, l2) {r['forms']}; deterministic, K2 on its gradient "
          f"bitwise its update rows; {r['smem']:,} bytes of dynamic shared "
          f"memory a CTA; ptxas {r['ptxas']}", flush=True)
    report_k1_wide(w)
    print(f"phase 2: K3 at {w['rows']} rows of {w['width']:,} f32 "
          f"({w['distinct']} distinct relations), bitwise its plain "
          f"version: {fmt_s(*w['k3_ms'])} ms "
          f"(bound {w['k3_bound'][0]:.4f} ms, share "
          f"{w['k3_bound'][0] / w['k3_ms'][0]:.3f}; its fold alone "
          f"{fmt_s(*w['k3_fold_ms'])} ms; index_add_ "
          f"{fmt_s(*w['k3_library_ms'])} ms; fold grid {w['k3_grid']})",
          flush=True)


def dlrm_table():
    """The DLRM-DCNv2 tables cut to DLRM_CAP rows each: (rows per table,
    each table's first key)."""
    caps = np.minimum(np.asarray(DLRM_CARDS, np.int64), DLRM_CAP)
    return caps, np.concatenate([[0], np.cumsum(caps)[:-1]])


def dlrm_request(rng, caps, offs):
    """One lookup_bags request: DLRM_SAMPLES samples, one bag per sample
    and table of that table's multi-hot size, members zipf-skewed within
    their table. Returns (tables, bags) as lookup_bags takes them."""
    tables, bags = [], []
    for cap, off, h in zip(caps, offs, DLRM_HOTS):
        tables.append(off + skewed_keys(rng, int(cap), DLRM_SAMPLES * h))
        bags.append(np.arange(0, DLRM_SAMPLES * h + 1, h))
    return tables, bags


def k8_batch(rng, nreq, caps, offs):
    """One coalesced batch of the bag path: `nreq` requests of phase 10's
    traffic, planned by serve/bags.py plan_bag_batch. Returns (member
    keys, seg, bags)."""
    from adapm_tpu_torch.serve.bags import BagLookupRequest, plan_bag_batch
    reqs = []
    for _ in range(nreq):
        tables, bags = dlrm_request(rng, caps, offs)
        reqs.append(BagLookupRequest(tables, bags, "sum",
                                     np.concatenate(tables)))
    groups, _ = plan_bag_batch(reqs, np.zeros(int(caps.sum()), np.int32))
    g = groups[(0, "sum")]
    check(len(g["keys"]) == nreq * DLRM_SAMPLES * sum(DLRM_HOTS)
          and g["nbags"] == nreq * DLRM_SAMPLES * len(DLRM_HOTS),
          f"K8 batch: {len(g['keys'])} members, {g['nbags']} bags")
    return g["keys"], g["seg"], g["nbags"]


def k8_bytes(keys, use_c, c_sl, nbags):
    """The bytes K8's function must move for one batch of sum pooling:
    each distinct row read once (a main row for an owner-served member;
    a cache and a delta row for a replica-served one), per member its
    use_c flag, the two coordinates its flag selects and its seg, and the
    bags' rows read as starting values and written once. The bucket's
    padding (members with seg = OOB, empty bags past nbags) needs
    nothing."""
    rows = (len(np.unique(keys[~use_c]))
            + 2 * len(np.unique(c_sl[use_c])))
    return rows * L_DLRM * 4 + len(keys) * 13 + 2 * nbags * L_DLRM * 4


def phase_k8(K, dev, rng):
    """Phase 2, K8, over the full DLRM table at two batches of the bag
    path, each planned as phase 10 plans it and padded as
    ShardedStore.gather_pool pads it: the path's own (BAG_CLIENTS
    requests, the most its clients can have in flight; its numbers go
    into the kernels line) and one full coalesced batch (K8_REQUESTS,
    --sys.serve.max_batch). Sum and mean, with every member owner-served
    (S=1) and again with a quarter replica-served (S=2, cache + delta):
    bitwise its plain version and over two runs; timed in the trace and
    with CUDA events, beside its plain version and embedding_bag."""
    from adapm_tpu_torch.core.store import OOB, bucket_size, pad_bucket
    caps, offs = dlrm_table()
    nkeys = int(caps.sum())
    slots = -8 * (-int(np.ceil(nkeys * 1.25)) // 8)      # the store's rule
    main = torch.randn((1, slots, L_DLRM), device=dev)
    main[0, :4] = -0.0
    main2 = main.view(2, slots // 2, L_DLRM)
    cslots = 65_536
    cache1 = torch.randn((1, 8, L_DLRM), device=dev)
    delta1 = torch.randn((1, 8, L_DLRM), device=dev)
    cache2 = torch.randn((2, cslots, L_DLRM), device=dev)
    delta2 = torch.randn((2, cslots, L_DLRM), device=dev)
    s1, s2 = "S=1", "S=2, 1/4 replica-served"
    recs = {}
    for nreq in (BAG_CLIENTS, K8_REQUESTS):
        keys, seg, nbags = k8_batch(rng, nreq, caps, offs)
        n = len(keys)
        nb = bucket_size(nbags)

        def cols(*arrays_and_fills, n=n):
            return [torch.as_tensor(a, device=dev)
                    for a in pad_bucket(n, *arrays_and_fills)]

        z = np.zeros(n, np.int32)
        seg_t = cols((seg, OOB))[0]
        o_sh1, o_sl1 = cols((z, 0), (keys.astype(np.int32), OOB))
        no_c = cols((z, 0), (np.full(n, OOB, np.int32), OOB),
                    (z > 0, False))
        # S=2: owners k % 2, k // 2; a quarter from shard 0's replicas,
        # with o_sl = OOB where the cache serves (as the batcher routes)
        use_c = rng.random(n) < 0.25
        c_sl = rng.integers(0, cslots, n).astype(np.int32)
        o_sl2 = np.where(use_c, OOB, keys // 2).astype(np.int32)
        rep = cols(((keys % 2).astype(np.int32), 0), (o_sl2, OOB), (z, 0),
                   (c_sl, OOB), (use_c, False))
        forms = {s1: (main, cache1, delta1, o_sh1, o_sl1, *no_c),
                 s2: (main2, cache2, delta2, *rep)}
        errs = {}
        for form, args in forms.items():
            for pooling in ("sum", "mean"):
                outs = [K.gather_pool(*args, seg_t,
                                      torch.zeros((nb, L_DLRM), device=dev),
                                      pooling, sorted_seg=True)
                        for _ in range(2)]
                ref = K.gather_pool_plain(
                    *args, seg_t, torch.zeros((nb, L_DLRM), device=dev),
                    pooling)
                check(torch.equal(outs[0].view(torch.int32),
                                  outs[1].view(torch.int32)),
                      f"K8 ({nreq} requests, {form}, {pooling}) is not "
                      "deterministic")
                check(torch.equal(outs[0].view(torch.int32),
                                  ref.view(torch.int32)),
                      f"K8 ({nreq} requests, {form}, {pooling}) differs "
                      "from its plain version")
                errs[f"{form} {pooling}"] = float(
                    (outs[0] - ref).abs().max())
        out = torch.zeros((nb, L_DLRM), device=dev)

        def k8(pooling="sum", a=forms[s1], seg_t=seg_t, out=out):
            K.gather_pool(*a, seg_t, out, pooling, sorted_seg=True)

        trace, _ = kernel_ms(k8, "gather_pool_kernel")
        # the diagnosis: the same members re-planned into bags of equal
        # length, which takes the long bags out of the batch
        sizes = np.full(nbags, n // nbags)
        sizes[:n % nbags] += 1
        seg_eq = cols((np.repeat(np.arange(nbags), sizes).astype(np.int32),
                       OOB))[0]
        eq = [K.gather_pool(*forms[s1], seg_eq,
                            torch.zeros((nb, L_DLRM), device=dev), "sum",
                            sorted_seg=True) for _ in range(2)]
        check(torch.equal(eq[0].view(torch.int32), eq[1].view(torch.int32))
              and torch.equal(eq[0].view(torch.int32), K.gather_pool_plain(
                  *forms[s1], seg_eq, torch.zeros((nb, L_DLRM), device=dev),
                  "sum").view(torch.int32)),
              f"K8 ({nreq} requests, equal-length bags) differs from its "
              "plain version or between two runs")
        equal = kernel_ms(lambda: K.gather_pool(
            *forms[s1], seg_eq, out, "sum", sorted_seg=True),
            "gather_pool_kernel")[0]
        flat = torch.as_tensor(keys, device=dev)
        starts = torch.as_tensor(np.searchsorted(seg, np.arange(nbags)),
                                 device=dev)
        table = main.view(-1, L_DLRM)
        library = cuda_ms(lambda: torch.nn.functional.embedding_bag(
            flat, table, starts, mode="sum"))
        lib_err = float((torch.nn.functional.embedding_bag(
            flat, table, starts, mode="sum") - K.gather_pool(
                *forms[s1], seg_t, torch.zeros((nb, L_DLRM), device=dev),
                "sum", sorted_seg=True)[:nbags]).abs().max())
        nrep = int(use_c.sum())
        recs[nreq] = timed(
            trace, cuda_ms(lambda: K.gather_pool_plain(
                *forms[s1], seg_t, out, "sum"), reps=5, warmup=1),
            library, max_abs_err=max(errs.values()), forms_err=errs,
            event_ms=cuda_ms(k8), mean_trace_ms=kernel_ms(
                lambda: k8("mean"), "gather_pool_kernel")[0],
            replica_trace_ms=kernel_ms(
                lambda: k8("sum", forms[s2]), "gather_pool_kernel")[0],
            bound=bound(k8_bytes(keys, z > 0, c_sl, nbags), n * L_DLRM),
            replica_bound=bound(k8_bytes(keys, use_c, c_sl, nbags),
                                (n + nrep) * L_DLRM),
            requests=nreq, members=n, bags=nbags,
            distinct_rows=int(len(np.unique(keys))),
            longest_bag=int(np.bincount(seg).max()), equal_ms=equal,
            equal_bag_sizes=(int(sizes.min()), int(sizes.max())),
            prior_ms=K8_PRIOR_MS.get(nreq),
            library_max_abs_diff=lib_err)
    return dict(recs[BAG_CLIENTS], full_batch=recs[K8_REQUESTS],
                ptxas=ptxas_summary("gather_pool"))


def timed(ms, plain_ms, library_ms, **kw):
    """A kernel record from (median, min, max) timings."""
    out = dict(kw, ms=ms[0], ms_spread=ms[1:], plain_ms=plain_ms[0],
               plain_ms_spread=plain_ms[1:])
    out["library_ms"] = None if library_ms is None else library_ms[0]
    out["library_ms_spread"] = None if library_ms is None \
        else library_ms[1:]
    return out


def phase_k4(K, dev, rng):
    """K4 against its plain version at eval width: a 200,000-entity
    ComplEx pool (rows of 512 f32, K=256 read through the row stride) in
    4 chunks of 65,536 keys with a padded tail, the RESCAL form (K=128)
    on the same pool, each at the app's full batch of 64 queries and its
    tail batch of 36 (100 eval triples); exact on integer data at both
    batch sizes."""
    from adapm_tpu_torch.models.kge import (_complex_queries,
                                            _rescal_queries, complex_score,
                                            rescal_score)
    nk = E + R
    slots = -8 * (-int(np.ceil(nk * 1.25)) // 8)
    pool = torch.randn((1, slots, L), device=dev) * 0.1
    owner = torch.zeros(nk, dtype=torch.int32, device=dev)
    slot = torch.as_tensor(rng.permutation(slots)[:nk].astype(np.int32),
                           device=dev)
    nch = -(-E // EVAL_CHUNK)
    pad = np.zeros(nch * EVAL_CHUNK, np.int32)
    pad[:E] = rng.permutation(E)
    pad[E:] = pad[0]
    keys = torch.as_tensor(pad.reshape(nch, EVAL_CHUNK), device=dev)
    s_k = torch.as_tensor(rng.integers(0, E, EVAL_B).astype(np.int32),
                          device=dev)
    o_k = torch.as_tensor(rng.integers(0, E, EVAL_B).astype(np.int32),
                          device=dev)
    r_k = torch.as_tensor(rng.integers(E, nk, EVAL_B).astype(np.int32),
                          device=dev)

    def rows(k, dim):
        return pool[0, slot[k.long()], :dim]

    # exact: small integers make every partial sum exact in f32, so the
    # kernel's counts must equal the plain version's in any order; true
    # scores taken from real candidates make exact ties (not counted)
    ipool = torch.randint(-4, 5, pool.shape, device=dev).float()
    Ki = 2 * D_MODEL
    qi_o = torch.randint(-3, 4, (EVAL_B, Ki), device=dev).float()
    qi_s = torch.randint(-3, 4, (EVAL_B, Ki), device=dev).float()
    cand_i = ipool[0, slot[o_k.long()], :Ki]
    true_i = (qi_o * cand_i).sum(1).contiguous()
    exact_counted = 0
    for nb in K4_BATCHES:
        iargs = (ipool, owner, slot, keys, E, qi_o[:nb].contiguous(),
                 qi_s[:nb].contiguous(), true_i[:nb].contiguous(),
                 o_k[:nb].contiguous(), s_k[:nb].contiguous())
        ge = K.pool_eval_counts(*iargs, parts=2)
        pe = K.pool_eval_counts_plain(*iargs, parts=2)
        check(all(torch.equal(a, b) for a, b in zip(ge, pe)),
              f"K4 counts differ from the plain version on integer data "
              f"at B={nb}")
        exact_counted += int(ge[0].sum() + ge[1].sum())
    del ipool, cand_i

    out = {}
    for model in ("complex", "rescal"):
        d = D_MODEL
        if model == "complex":
            se, re_, oe = rows(s_k, 2 * d), rows(r_k, 2 * d), rows(o_k, 2 * d)
            a, b, c, dd = _complex_queries(se, re_, oe)
            q_o, q_s = torch.cat([a, b], -1), torch.cat([c, dd], -1)
            true = complex_score(se, re_, oe)
            parts = 2
        else:
            se, oe = rows(s_k, d), rows(o_k, d)
            re_ = torch.randn((EVAL_B, d * d), device=dev) * 0.1
            q_o, q_s = _rescal_queries(se, re_, oe)
            true = rescal_score(se, re_, oe)
            parts = 1
        Kd = q_o.shape[1]
        flat = slot[torch.as_tensor(pad[:E], device=dev).long()]
        cand = pool[0, flat, :Kd].contiguous()   # the dense yardstick
        for nb in K4_BATCHES:
            qo, qs, tr = (x[:nb].contiguous() for x in (q_o, q_s, true))
            args = (pool, owner, slot, keys, E, qo, qs, tr,
                    o_k[:nb].contiguous(), s_k[:nb].contiguous())
            g_o, g_s = K.pool_eval_counts(*args, parts=parts)
            p_o, p_s, t_o, t_s = K.pool_eval_counts_plain(
                *args, parts=parts, ties=True)
            torch.cuda.synchronize()
            diff = torch.cat([(g_o - p_o).abs(), (g_s - p_s).abs()])
            ties = torch.cat([t_o, t_s])
            check(bool((diff <= ties).all()),
                  f"K4 ({model}, B={nb}) counts differ from the plain "
                  f"version beyond the near-tie rule: diff {diff.tolist()} "
                  f"ties {ties.tolist()}")
            check(bool((g_o > 0).any() and (g_o < E - 1).any()),
                  f"K4 ({model}, B={nb}) counts are degenerate")

            def library():
                t = tr[:, None]
                return ((qo @ cand.T) > t).sum(1), ((qs @ cand.T) > t).sum(1)

            out[model, nb] = timed(
                max_abs_err=float(diff.max()), ties=int(ties.sum()),
                counted=int(g_o.sum() + g_s.sum()), K=Kd, B=nb,
                ms=cuda_ms(lambda: K.pool_eval_counts(*args, parts=parts)),
                plain_ms=cuda_ms(lambda: K.pool_eval_counts_plain(
                    *args, parts=parts)),
                library_ms=cuda_ms(library),
                # each real candidate row's K floats read once; 2 sides x
                # B x E x K multiply-adds, 2 operations each
                bound=bound(E * Kd * 4 + E * 4 + 2 * nb * Kd * 4,
                            2 * 2 * nb * E * Kd))
        del cand
    rec = dict(out["complex", EVAL_B])
    rec["forms"] = {f"{m} B={nb}": r for (m, nb), r in out.items()}
    rec["exact_counted"] = exact_counted
    plan = getattr(K, "_k4_plan", None)
    if plan is not None:    # absent from trees before the launch plan
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        rec["plans"] = {f"K={kd} B={nb}": plan(nb, kd, L, E, sms)._asdict()
                        for kd in (2 * D_MODEL, D_MODEL)
                        for nb in K4_BATCHES}
    rec["ptxas"] = ptxas_summary("pool_eval_counts")
    rec["cell"] = phase_k4_cell(K, dev, rng)
    return rec


def phase_k4_cell(K, dev, rng):
    """K4 at the benchmark's eval cell's shape (complex_wd5m.eval_b64):
    Wikidata5M's 4,594,485 entities in 65,536-key chunks, a pool of rows
    of [emb 512 | adagrad 512] f32 (K=512 read through the row stride),
    B=64; normal(0, 0.1) rows and queries, each true score a real
    candidate's. Timed in the trace, in two rounds of alternating order:
    the one-CTA-a-block forms through the C entry with their plans
    (resident Bq=32 x 2, the wrapper's plan here before the pair form;
    streamed Bq=64; streamed Bq=32 x 2) and the wrapper's own plan where
    it is another. Every plan's counts bitwise the first's and within
    the near-tie rule of the plain version; matmul + compare + sum over
    the dense candidate rows as library_ms; K4_FORMS over the wrapper's
    launches."""
    E4, Kd, L4, nb = K4_CELL
    slots = -8 * (-int(np.ceil(E4 * 1.02)) // 8)
    pool = torch.empty((1, slots, L4), device=dev).normal_(0.0, 0.1)
    owner = torch.zeros(E4, dtype=torch.int32, device=dev)
    slot = torch.as_tensor(rng.permutation(slots)[:E4].astype(np.int32),
                           device=dev)
    nch = -(-E4 // EVAL_CHUNK)
    pad = np.zeros(nch * EVAL_CHUNK, np.int32)
    pad[:E4] = rng.permutation(E4)
    keys = torch.as_tensor(pad.reshape(nch, EVAL_CHUNK), device=dev)
    o_k, s_k = (torch.as_tensor(rng.integers(0, E4, nb).astype(np.int32),
                                device=dev) for _ in range(2))
    q_o, q_s = (torch.randn((nb, Kd), device=dev) * 0.1 for _ in range(2))
    true = (q_o * pool[0, slot[o_k.long()], :Kd]).sum(1).contiguous()
    args = (pool, owner, slot, keys, E4, q_o, q_s, true, o_k, s_k)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {f"{'resident' if res else 'streamed'} Bq={bq}"
             f"{'' if bq == nb else ' x2'}":
             K._k4_block_plan(bq, res, nb, Kd, E4, sms, True)
             for bq, res in ((32, True), (64, False), (32, False))}
    K.reset_launches()
    K.pool_eval_counts(*args)
    forms = {f: n for f, n in K.K4_FORMS.items() if n}
    shipped = K._k4_plan(nb, Kd, L4, E4, sms)
    if shipped not in plans.values():
        plans[f"wrapper's ({shipped.form})"] = shipped
    counts = {}
    for name, plan in plans.items():
        counts[name] = [t.cpu() for t in K._k4_launch(plan, *args)]
    first = next(iter(counts.values()))
    for name, c in counts.items():
        check(all(torch.equal(a, b) for a, b in zip(c, first)),
              f"K4 at the cell's shape: the {name} plan's counts differ "
              f"from the {next(iter(counts))} plan's")
    p_o, p_s, t_o, t_s = K.pool_eval_counts_plain(*args, parts=2, ties=True)
    diff = torch.cat([(first[0] - p_o.cpu()).abs(),
                      (first[1] - p_s.cpu()).abs()])
    ties = torch.cat([t_o, t_s]).cpu()
    check(bool((diff <= ties).all()), f"K4 at the cell's shape differs "
          f"from the plain version beyond the near-tie rule: diff "
          f"{diff.tolist()} ties {ties.tolist()}")
    check(bool((first[0] > 0).any() and (first[0] < E4 - 1).any()),
          "K4 at the cell's shape: counts are degenerate")
    ms = {name: [] for name in plans}
    for order in (list(plans), list(plans)[::-1]):
        for name in order:
            t, _ = kernel_ms(lambda p=plans[name]: K._k4_launch(p, *args),
                             "pool_eval_counts_kernel", reps=10, warmup=2)
            ms[name].append(t)
    cand = pool[0, slot[torch.as_tensor(pad[:E4], device=dev).long()], :Kd]
    del pool

    def library():
        t = true[:, None]
        return ((q_o @ cand.T) > t).sum(1), ((q_s @ cand.T) > t).sum(1)

    lib_ms = cuda_ms(library, reps=5, warmup=1)
    del cand
    torch.cuda.empty_cache()
    return dict(E=E4, K=Kd, L=L4, B=nb, ms=ms, library_ms=lib_ms,
                plans={n: p._asdict() | {"form": p.form}
                       for n, p in plans.items()},
                shipped=shipped.form, forms=forms,
                max_abs_err=float(diff.max()), ties=int(ties.sum()),
                counted=int(first[0].sum() + first[1].sum()),
                bound=bound(E4 * Kd * 4 + E4 * 4 + 2 * nb * Kd * 4,
                            2 * 2 * nb * E4 * Kd))


def phase_k4_mp(K, dev, rng):
    """K4 in its multi-process form (models/kge.py
    make_pool_eval_counts_mp, the eval entry each rank calls) at the
    app's eval width over one rank's half of the candidates: a
    200,000-entity pool (rows of 512 f32), 100,000 owned entities in two
    65,536-key tiles (the second padded), the query triples as rows and
    the true score an input, at B=64 and the app's tail B=36, for
    ComplEx (K=256) and RESCAL (K=128): exact on integer-valued rows,
    under the near-tie rule on random rows. Timed are K4 on the formed
    queries (`ms`), the whole entry with its query forming (`entry_ms`),
    K4's plain version and matmul + compare + sum over the owned rows."""
    from adapm_tpu_torch.models.kge import (_complex_queries,
                                            _rescal_queries,
                                            make_pool_eval_counts_mp,
                                            make_true_score)
    nk = E + R
    slots = -8 * (-int(np.ceil(nk * 1.25)) // 8)
    pool = torch.randn((1, slots, L), device=dev) * 0.1
    owner = torch.zeros(nk, dtype=torch.int32, device=dev)
    slot = torch.as_tensor(rng.permutation(slots)[:nk].astype(np.int32),
                           device=dev)
    tables = (owner, slot, None)
    nown = E // 2
    owned = rng.permutation(E)[:nown].astype(np.int32)
    nch = -(-nown // EVAL_CHUNK)
    pad = np.full(nch * EVAL_CHUNK, owned[0], np.int32)
    pad[:nown] = owned
    keys = torch.as_tensor(pad.reshape(nch, EVAL_CHUNK), device=dev)
    s_k = torch.as_tensor(rng.integers(0, E, EVAL_B).astype(np.int32),
                          device=dev)
    o_k = torch.as_tensor(rng.integers(0, E, EVAL_B).astype(np.int32),
                          device=dev)
    r_k = torch.as_tensor(rng.integers(E, nk, EVAL_B).astype(np.int32),
                          device=dev)
    widths = {"complex": (2 * D_MODEL, 2 * D_MODEL),
              "rescal": (D_MODEL, D_MODEL * D_MODEL)}
    fns = {m: make_pool_eval_counts_mp(m, kd, rd, EVAL_CHUNK)
           for m, (kd, rd) in widths.items()}

    def rows(p, k, dim):
        return p[0, slot[k.long()], :dim].contiguous()

    def batch(p, model, re_, nb):
        kd = widths[model][0]
        se, oe = rows(p, s_k[:nb], kd), rows(p, o_k[:nb], kd)
        re_ = re_[:nb].contiguous()
        true = make_true_score(model)(se, re_, oe).contiguous()
        return (p, tables, keys, nown, se, re_, oe, s_k[:nb].contiguous(),
                o_k[:nb].contiguous(), true)

    # exact on integer rows: both models, both batch sizes
    ipool = torch.randint(-3, 4, pool.shape, device=dev).float()
    exact_counted = 0
    for model, (kd, rd) in widths.items():
        ire = torch.randint(-2, 3, (EVAL_B, rd), device=dev).float()
        for nb in K4_BATCHES:
            iargs = batch(ipool, model, ire, nb)
            ge = fns[model](*iargs)
            pe = fns[model](*iargs, ties=True)[:2]
            check(all(torch.equal(a, b) for a, b in zip(ge, pe)),
                  f"K4 (multi-process form, {model}) counts differ from "
                  f"the plain version on integer rows at B={nb}")
            exact_counted += int(ge[0].sum() + ge[1].sum())
    del ipool

    out = {}
    for model, (kd, rd) in widths.items():
        re_ = rows(pool, r_k, rd) if model == "complex" else \
            torch.randn((EVAL_B, rd), device=dev) * 0.1
        cand = pool[0, slot[torch.as_tensor(owned, device=dev).long()],
                    :kd].contiguous()     # the dense yardstick's rows
        parts = 2 if model == "complex" else 1
        for nb in K4_BATCHES:
            args = batch(pool, model, re_, nb)
            g_o, g_s = fns[model](*args)
            p_o, p_s, t_o, t_s = fns[model](*args, ties=True)
            torch.cuda.synchronize()
            diff = torch.cat([(g_o - p_o).abs(), (g_s - p_s).abs()])
            ties = torch.cat([t_o, t_s])
            check(bool((diff <= ties).all()),
                  f"K4 (multi-process form, {model}, B={nb}) counts "
                  f"differ from the plain version beyond the near-tie "
                  f"rule: diff {diff.tolist()} ties {ties.tolist()}")
            check(bool((g_o > 0).any() and (g_o < nown - 1).any()),
                  f"K4 (multi-process form, {model}, B={nb}) counts are "
                  f"degenerate")
            se, re_b, oe, tr = args[4], args[5], args[6], args[9]
            if model == "complex":
                a, b, c, dd = _complex_queries(se, re_b, oe)
                q_o, q_s = torch.cat([a, b], -1), torch.cat([c, dd], -1)
            else:
                q_o, q_s = (q.contiguous()
                            for q in _rescal_queries(se, re_b, oe))
            kargs = (pool, owner, slot, keys, nown, q_o, q_s, tr,
                     args[8], args[7])

            def library():
                t = tr[:, None]
                return ((q_o @ cand.T) > t).sum(1), \
                    ((q_s @ cand.T) > t).sum(1)

            entry = cuda_ms(lambda: fns[model](*args))
            out[model, nb] = timed(
                max_abs_err=float(diff.max()), ties=int(ties.sum()),
                counted=int(g_o.sum() + g_s.sum()), K=kd, B=nb,
                nvalid=nown, entry_ms=entry[0], entry_ms_spread=entry[1:],
                ms=cuda_ms(lambda: K.pool_eval_counts(*kargs, parts=parts)),
                plain_ms=cuda_ms(lambda: K.pool_eval_counts_plain(
                    *kargs, parts=parts)),
                library_ms=cuda_ms(library),
                # each owned candidate row's K floats and key read once,
                # the query coefficients read once; 2 sides x B x nvalid
                # x K multiply-adds, 2 operations each
                bound=bound(nown * kd * 4 + nown * 4 + 2 * nb * kd * 4,
                            2 * 2 * nb * nown * kd))
        del cand
    rec = dict(out["complex", EVAL_B])
    rec["forms"] = {f"{m} B={nb}": r for (m, nb), r in out.items()}
    rec["exact_counted"] = exact_counted
    return rec


def report_k4_mp(r):
    for form, f in r["forms"].items():
        print(f"phase 2: K4 multi-process form {form} K={f['K']} over "
              f"{f['nvalid']} owned candidates: {fmt_t(f, 'ms')} ms (bound "
              f"{f['bound'][0]:.4f} ms, {f['bound'][1]}, share "
              f"{f['bound'][0] / f['ms']:.3f}), entry with its query "
              f"forming {fmt_t(f, 'entry_ms')} ms, plain "
              f"{fmt_t(f, 'plain_ms')} ms, matmul+compare+sum "
              f"{fmt_t(f, 'library_ms')} ms, count diff {f['max_abs_err']}"
              f" within {f['ties']} near-ties, {f['counted']} counted",
              flush=True)
    print(f"phase 2: K4 multi-process form exact on integer rows "
          f"(ComplEx and RESCAL) at B={K4_BATCHES}: "
          f"{r['exact_counted']} counted", flush=True)


def k17_bound(nb, n, d):
    """K17's least time for nb queries a side over n candidates of d
    complex components: each (query, side, candidate, component) takes 6
    f32 operations and one square root on the SFU; each candidate's 2d
    floats, key, owner and slot are read once (benchmark/costs/k17.py's
    count). (ms, "roots" | "operations" | "bytes")."""
    roots = 2 * nb * n * d
    nbytes = n * 2 * d * 4 + n * 12 + 2 * nb * 2 * d * 4 + nb * 20
    return max((roots / SFU_PER_S * 1e3, "roots"),
               (6 * roots / F32_FLOPS * 1e3, "operations"),
               (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))


def k17_queries(se, re_, oe):
    """RotatE's query rows and true distances as the eval program forms
    them (models/kge.py _k17_counts): a = s o r, b = o o conj(r), d_true
    = -rank score."""
    from adapm_tpu_torch.models.kge import _rotate_queries, rotate_score
    q_o, q_s = _rotate_queries(se, re_, oe)
    return (q_o.contiguous(), q_s.contiguous(),
            (-rotate_score(se, re_, oe)).contiguous())


def k17_within(K, args, got, what):
    """K17's counts `got` within the near-tie rule of its plain version on
    the same inputs; returns (max count diff, near-ties, counted)."""
    p_o, p_s, t_o, t_s = K.pool_eval_dist_plain(*args, ties=True)
    diff = torch.cat([(got[0] - p_o).abs(), (got[1] - p_s).abs()])
    ties = torch.cat([t_o, t_s])
    check(bool((diff <= ties).all()), f"{what}: counts differ from the "
          f"plain version beyond the near-tie rule: diff {diff.tolist()} "
          f"ties {ties.tolist()}")
    n = args[4]
    check(bool((got[0] > 0).any() and (got[0] < n - 1).any()),
          f"{what}: counts are degenerate")
    return int(diff.max()), int(ties.sum()), int(got[0].sum() + got[1].sum())


def phase_k17(K, dev, rng):
    """K17 pool_eval_dist (RotatE's count by distance) against its plain
    version: at eval width (the 200,000-entity pool of rows of 512 f32,
    d=128 read through the row stride, 65,536-key chunks) at B=64 and 36,
    exact on integer-valued rows whose imaginary halves are zero (every
    component's modulus an integer, the true distance half-way between
    two, so no evaluation error can move a count) and within the near-tie
    rule on random RotatE queries, equal over two runs; at the benchmark
    cell's shape (phase_k17_cell); RotatE's eval program on a server's
    pool with its launches held to K1 and K17 (phase_k17_path); and a
    small --model rotate app run on the card."""
    d = D_MODEL
    nk = E + R
    slots = -8 * (-int(np.ceil(nk * 1.25)) // 8)
    owner = torch.zeros(nk, dtype=torch.int32, device=dev)
    slot = torch.as_tensor(rng.permutation(slots)[:nk].astype(np.int32),
                           device=dev)
    nch = -(-E // EVAL_CHUNK)
    pad = np.zeros(nch * EVAL_CHUNK, np.int32)
    pad[:E] = rng.permutation(E)
    pad[E:] = pad[0]
    keys = torch.as_tensor(pad.reshape(nch, EVAL_CHUNK), device=dev)
    s_k, o_k = (torch.as_tensor(rng.integers(0, E, EVAL_B).astype(np.int32),
                                device=dev) for _ in range(2))

    ipool = torch.randint(-4, 5, (1, slots, L), device=dev).float()
    ipool[..., d:2 * d] = 0
    q_i = [torch.randint(-3, 4, (EVAL_B, 2 * d), device=dev).float()
           for _ in range(2)]
    for q in q_i:
        q[:, d:] = 0
    true_rows = ipool[0, slot[o_k.long()], :2 * d]
    d_i = (K._complex_distance(q_i[0], true_rows).diagonal() + 0.5)
    exact_counted = 0
    for nb in K4_BATCHES:
        args = (ipool, owner, slot, keys, E, q_i[0][:nb].contiguous(),
                q_i[1][:nb].contiguous(), d_i[:nb].contiguous(),
                o_k[:nb].contiguous(), s_k[:nb].contiguous())
        got = K.pool_eval_dist(*args)
        p_o, p_s, t_o, t_s = K.pool_eval_dist_plain(*args, ties=True)
        check(torch.equal(got[0], p_o) and torch.equal(got[1], p_s)
              and int(t_o.sum() + t_s.sum()) == 0,
              f"K17 counts differ from the plain version on integer data "
              f"at B={nb}")
        exact_counted += int(got[0].sum() + got[1].sum())
    del ipool, true_rows

    pool = torch.randn((1, slots, L), device=dev) * 0.1
    se, oe = (pool[0, slot[k.long()], :2 * d] for k in (s_k, o_k))
    re_ = torch.randn((EVAL_B, 2 * d), device=dev) * np.pi
    q_o, q_s, d_true = k17_queries(se, re_, oe)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    forms, plans = {}, {}
    for nb in K4_BATCHES:
        args = (pool, owner, slot, keys, E, q_o[:nb].contiguous(),
                q_s[:nb].contiguous(), d_true[:nb].contiguous(),
                o_k[:nb].contiguous(), s_k[:nb].contiguous())
        runs = [K.pool_eval_dist(*args) for _ in range(2)]
        check(all(torch.equal(a, b) for a, b in zip(*runs)),
              f"K17 (B={nb}) differs between two runs")
        err, ties, counted = k17_within(K, args, runs[0], f"K17 (B={nb})")
        trace_ms, _ = kernel_ms(lambda a=args: K.pool_eval_dist(*a),
                                "pool_eval_dist_kernel")
        forms[f"B={nb}"] = timed(
            max_abs_err=err, ties=ties, counted=counted, K=2 * d, B=nb,
            ms=cuda_ms(lambda a=args: K.pool_eval_dist(*a)),
            plain_ms=cuda_ms(lambda a=args: K.pool_eval_dist_plain(*a),
                             reps=3, warmup=1),
            library_ms=None, trace_ms=trace_ms,
            bound=k17_bound(nb, E, d))
        plans[f"d={d} B={nb}"] = K._k17_plan(nb, d, L, E, sms)._asdict()
    del pool, se, oe
    torch.cuda.empty_cache()
    rec = dict(forms[f"B={EVAL_B}"], forms=forms, plans=plans,
               exact_counted=exact_counted)
    rec["ptxas"] = ptxas_summary("pool_eval_dist")
    rec["cell"] = phase_k17_cell(K, dev, rng)
    torch.cuda.empty_cache()
    rec["path"] = phase_k17_path(K, dev)
    return rec


def phase_k17_cell(K, dev, rng):
    """K17 at the benchmark's RotatE cell's shape (rotate_wd5m.eval_b64):
    Wikidata5M's 4,594,485 entities in 65,536-key chunks, a pool of rows
    of [emb 512 | adagrad 512] f32 (d=256 read through the row stride),
    B=64; normal(0, 0.1) rows, phases normal(0, pi), each query's true
    triple a real candidate's. Counts within the near-tie rule of the
    plain version and equal over two runs; device ms in the trace and
    between CUDA events beside the bound, the plain version's ms."""
    E4, d4, L4, nb = K17_CELL
    slots = -8 * (-int(np.ceil(E4 * 1.02)) // 8)
    pool = torch.empty((1, slots, L4), device=dev).normal_(0.0, 0.1)
    owner = torch.zeros(E4, dtype=torch.int32, device=dev)
    slot = torch.as_tensor(rng.permutation(slots)[:E4].astype(np.int32),
                           device=dev)
    nch = -(-E4 // EVAL_CHUNK)
    pad = np.zeros(nch * EVAL_CHUNK, np.int32)
    pad[:E4] = rng.permutation(E4)
    keys = torch.as_tensor(pad.reshape(nch, EVAL_CHUNK), device=dev)
    s_k, o_k = (torch.as_tensor(rng.integers(0, E4, nb).astype(np.int32),
                                device=dev) for _ in range(2))
    se, oe = (pool[0, slot[k.long()], :2 * d4] for k in (s_k, o_k))
    re_ = torch.randn((nb, 2 * d4), device=dev) * np.pi
    args = (pool, owner, slot, keys, E4, *k17_queries(se, re_, oe), o_k,
            s_k)
    runs = [K.pool_eval_dist(*args) for _ in range(2)]
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          "K17 at the cell's shape differs between two runs")
    t0 = time.perf_counter()
    err, ties, counted = k17_within(K, args, runs[0],
                                    "K17 at the cell's shape")
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    trace_ms, _ = kernel_ms(lambda: K.pool_eval_dist(*args),
                            "pool_eval_dist_kernel", reps=10, warmup=2)
    ev_ms = cuda_ms(lambda: K.pool_eval_dist(*args), reps=10, warmup=1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = K._k17_plan(nb, d4, L4, E4, sms, K._aligned16(pool, *args[5:7]))
    del pool, se, oe, args
    torch.cuda.empty_cache()
    return dict(E=E4, d=d4, L=L4, B=nb, trace_ms=trace_ms, ms=ev_ms,
                plain_s=plain_s, plan=plan._asdict(), max_abs_err=err,
                ties=ties, counted=counted, bound=k17_bound(nb, E4, d4))


# a small RotatE app run on the card, device routes: tests/
# test_torch_rotate.py's configuration (there on the CPU)
ROTATE_APP_ARGS = ["--model", "rotate", "--dim", "8", "--neg_ratio", "4",
                   "--synthetic_entities", "60", "--synthetic_relations",
                   "4", "--synthetic_triples", "400", "--epochs", "6",
                   "--batch_size", "32", "--lr", "0.2", "--eval_every", "6",
                   "--eval_triples", "60", "--self_adv_temp", "1.0",
                   "--margin", "6", "--eval_chunk", "16", "--num_shards",
                   "8", "--sys.sync.max_per_sec", "0", "--sys.prefetch", "0"]
# the kernels RotatE's app launches: its eval (K1 gathers of the query
# rows, K17), and its training step (K1, autograd + K2, K3)
ROTATE_APP_KERNELS = ("routed_gather", "adagrad_update",
                      "ordered_scatter_add", "pool_eval_dist")
ROTATE_EVAL_BATCHES = (EVAL_B,) * 4 + (36,)


def phase_k17_path(K, dev):
    """RotatE's eval program (models/kge.py make_pool_eval_counts, shared
    pool) on a server's pool: kge_table's 201,000 keys of rows of 512
    f32, the relation rows' first d columns phases normal(0, pi), the
    worker's device mirrors, 4 batches of 64 and one of 36. The counts
    are set to 0 just before and read just after: exactly 3 K1 and one
    K17 a batch, nothing else; the first batch within the near-tie rule
    of the program's plain form; ms a batch between CUDA events. Then
    the small --model rotate app on the card, device routes: its launches
    held to K1, K2, K3 and K17, its loss falling."""
    import adapm_tpu_torch as at
    from adapm_tpu_torch.apps import knowledge_graph_embeddings as kge_app
    from adapm_tpu_torch.models.kge import make_pool_eval_counts
    from adapm_tpu_torch.ops.fused import DeviceRouter
    d = D_MODEL
    srv, w = kge_table(at, dev, 17)
    try:
        fill = np.random.default_rng(18)
        rel = np.zeros((R, L), np.float32)
        rel[:, :d] = fill.normal(0, np.pi, (R, d))
        rel[:, L // 2:] = 1e-6
        w.set(np.arange(E, E + R), rel)
        srv.block()
        fn = make_pool_eval_counts("rotate", 2 * d, 2 * d, EVAL_CHUNK,
                                   shared_pool=True)
        nch = -(-E // EVAL_CHUNK)
        pad = np.zeros(nch * EVAL_CHUNK, np.int32)
        pad[:E] = np.arange(E)
        ent_keys = torch.as_tensor(pad.reshape(nch, EVAL_CHUNK), device=dev)
        main = srv.stores[0].main
        tables = DeviceRouter(srv, 0).tables()
        draw = np.random.default_rng(19)
        batches = [tuple(torch.as_tensor(x.astype(np.int32), device=dev)
                         for x in (draw.integers(0, E, nb),
                                   draw.integers(E, E + R, nb),
                                   draw.integers(0, E, nb)))
                   for nb in ROTATE_EVAL_BATCHES]
        torch.cuda.synchronize()
        K.reset_launches()
        got = [fn(main, tables, ent_keys, E, *b) for b in batches]
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        want = {"routed_gather": 3 * len(batches),
                "pool_eval_dist": len(batches)}
        check({k: v for k, v in launches.items() if v} == want,
              f"phase 2 (RotatE eval): launches {launches}, expected "
              f"{want} and nothing else")
        p = fn(main, tables, ent_keys, E, *batches[0], ties=True)
        diff = torch.cat([(got[0][0] - p[0]).abs(), (got[0][1] - p[1]).abs()])
        ties = torch.cat([p[3], p[4]])
        check(bool((diff <= ties).all()), f"phase 2 (RotatE eval): counts "
              f"differ from the plain form beyond the near-tie rule: diff "
              f"{diff.tolist()} ties {ties.tolist()}")
        check(torch.equal(got[0][2], p[2]), "phase 2 (RotatE eval): the "
              "true scores differ from the plain form's")
        batch_ms = cuda_ms(lambda: fn(main, tables, ent_keys, E,
                                      *batches[0]), reps=10, warmup=1)
    finally:
        srv.shutdown()
    res, app_launches = run_app(kge_app, K, ROTATE_APP_ARGS)
    check_app(res, app_launches, "phase 2 (RotatE app)", ROTATE_APP_KERNELS)
    losses = res["epoch_losses"]
    check(losses[-1] < 0.5 * losses[0], f"phase 2 (RotatE app): loss did "
          f"not fall: {losses}")
    check(res["mrr"] > 0.25, f"phase 2 (RotatE app): MRR {res['mrr']}")
    return dict(launches=launches, batches=len(batches),
                max_abs_err=int(diff.max()), ties=int(ties.sum()),
                batch_ms=batch_ms, app_launches=app_launches,
                app_losses=losses, app_mrr=res["mrr"])


def report_k17(r):
    """K17's lines: each batch against its plain version beside its
    bound, the plans, ptxas, the cell's shape, and RotatE's paths."""
    for form, f in r["forms"].items():
        print(f"phase 2: K17 {form} d={f['K'] // 2}: {fmt_t(f, 'ms')} ms "
              f"between events, {fmt_s(*f['trace_ms'])} ms in the trace "
              f"(bound {f['bound'][0]:.4f} ms, {f['bound'][1]}, share "
              f"{f['bound'][0] / f['trace_ms'][0]:.3f}), plain "
              f"{fmt_t(f, 'plain_ms')} ms, count diff {f['max_abs_err']} "
              f"within {f['ties']} near-ties, {f['counted']} counted",
              flush=True)
    print(f"phase 2: K17 exact on integer data at B={K4_BATCHES}: "
          f"{r['exact_counted']} counted, equal to the plain version, no "
          f"near-ties", flush=True)
    for key, p in r["plans"].items():
        print(f"phase 2: K17 plan {key}: {p}", flush=True)
    for e in r["ptxas"]:
        print(f"phase 2: K17 ptxas {e}", flush=True)
    c = r["cell"]
    b_ms = c["bound"][0]
    print(f"phase 2: K17 at the cell's shape (E={c['E']}, d={c['d']}, "
          f"L={c['L']}, B={c['B']}): {fmt_s(*c['trace_ms'])} ms in the "
          f"trace, {fmt_s(*c['ms'])} ms between events (bound {b_ms:.4f} "
          f"ms, {c['bound'][1]}, share {b_ms / c['trace_ms'][0]:.3f}); "
          f"plain {c['plain_s']:.3f} s; count diff {c['max_abs_err']} "
          f"within {c['ties']} near-ties of the plain version, "
          f"{c['counted']} counted; plan {c['plan']}", flush=True)
    p = r["path"]
    used = {k: v for k, v in p["launches"].items() if v}
    app_used = {k: v for k, v in p["app_launches"].items() if v}
    print(f"phase 2: RotatE eval program on a server's pool: "
          f"{p['batches']} batches, launches {used}, batch of "
          f"{EVAL_B} {fmt_s(*p['batch_ms'])} ms, count diff "
          f"{p['max_abs_err']} within {p['ties']} near-ties; RotatE app "
          f"(device routes) losses {[round(x, 4) for x in p['app_losses']]}"
          f", MRR {p['app_mrr']:.4g}, launches {app_used}",
          flush=True)


def ptxas_summary(name):
    """Registers, spills and static shared memory per kernel entry, from
    the newest `-Xptxas -v` log of library `name` under build/kernels/."""
    import glob
    import re
    logs = glob.glob(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "build", "kernels", f"lib{name}_*.ptxas.txt"))
    if not logs:
        return []
    with open(max(logs, key=os.path.getmtime)) as fh:
        text = fh.read()
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            # the kernel's name and its template arguments, still mangled
            k = re.search(r"([a-z][a-z0-9_]*_kernel)(?:I(.*?)EEv)?",
                          m.group(1))
            entry = m.group(1) if k is None else re.sub(
                r"^.*\d(?=[a-z])", "", k.group(1)) + (
                f"<{k.group(2)}>" if k.group(2) else "")
            cur = dict(entry=entry)
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers(?:, (\d+) bytes smem)?", line)
        if m:
            cur["registers"] = int(m.group(1))
            cur["static_smem"] = int(m.group(2) or 0)
    return out


class StepPath(NamedTuple):
    """One model's device-routed training step through the PM, as phases
    3 and 7 drive it: `build(seed)` returns (server, worker, runner) with
    the table filled from `seed`, `batches(rng, n)` n key batches; the
    step's lr, batch size and unit, the launches of one step, and the
    model kernel's name in a trace."""
    phase: str
    build: Callable
    batches: Callable
    lr: float
    B: int
    unit: str
    launches: dict
    kernel: str


def kge_table(at, dev, seed, **opts):
    """bench_tpu's table on `dev`: 201,000 keys of [emb 256 | adagrad
    256], a slab fill (normal x 0.1, accumulators 1e-6; none with seed
    None: a table a restore will overwrite). `opts` are further
    SystemOptions (the defaults run the prefetch pipeline)."""
    srv = at.setup(E + R, L, opts=at.SystemOptions(
        cache_slots_per_shard=1, sync_max_per_sec=0, **opts), device=dev)
    w = srv.make_worker(0)
    if seed is None:
        return srv, w
    fill = np.random.default_rng(seed)
    for lo in range(0, E + R, 50_000):
        hi = min(lo + 50_000, E + R)
        vals = fill.normal(size=(hi - lo, L)).astype(np.float32) * 0.1
        vals[:, L // 2:] = 1e-6
        w.set(np.arange(lo, hi), vals)
    srv.block()
    return srv, w


def kge_server(at, dev, seed, **opts):
    """kge_table and the device-routed ComplEx runner with uniform
    on-device negatives."""
    from adapm_tpu_torch.models import make_kge_loss
    from adapm_tpu_torch.ops.fused import DeviceRoutedRunner
    srv, w = kge_table(at, dev, seed, **opts)
    roles = ("s", "r", "o", "neg")
    return srv, w, DeviceRoutedRunner(
        srv, make_kge_loss("complex"), role_class=dict.fromkeys(roles, 0),
        role_dim=dict.fromkeys(roles, L // 2), neg_role="neg",
        neg_shape=(B, N), neg_population=np.arange(E), seed=0)


def rescal_server(at, dev, seed):
    """Phase 3's setup with RESCAL's two classes: E entity rows [emb d |
    adagrad d] of 256 f32 and R relation rows [emb d^2 | adagrad d^2] of
    32,768 f32 (keys as phase 3's), filled normal x 0.1 with accumulators
    1e-6 from `seed`, and the device-routed RESCAL runner with uniform
    on-device negatives [B, N]."""
    from adapm_tpu_torch.models import make_kge_loss
    from adapm_tpu_torch.ops.fused import DeviceRoutedRunner
    vl = np.concatenate([np.full(E, L_ENT_RESCAL), np.full(R, L_REL_RESCAL)])
    srv = at.setup(E + R, vl, opts=at.SystemOptions(
        cache_slots_per_shard=1, sync_max_per_sec=0), device=dev)
    w = srv.make_worker(0)
    fill = np.random.default_rng(seed)
    for lo, hi, width in ((0, E, L_ENT_RESCAL), (E, E + R, L_REL_RESCAL)):
        chunk = 50_000 * L // width
        for a in range(lo, hi, chunk):
            b = min(a + chunk, hi)
            vals = fill.normal(size=(b - a, width)).astype(np.float32) * 0.1
            vals[:, width // 2:] = 1e-6
            w.set(np.arange(a, b), vals)
    srv.block()
    ec, rc = int(srv.ab.key_class[0]), int(srv.ab.key_class[E])
    d = D_MODEL
    return srv, w, DeviceRoutedRunner(
        srv, make_kge_loss("rescal"),
        role_class={"s": ec, "r": rc, "o": ec, "neg": ec},
        role_dim={"s": d, "r": d * d, "o": d, "neg": d}, neg_role="neg",
        neg_shape=(B, N), neg_population=np.arange(E), seed=0)


def kge_batches(rng, n):
    """bench_tpu's batches: zipf-skewed subject and object keys."""
    return [{"s": skewed_keys(rng, E, B), "r": rng.integers(E, E + R, B),
             "o": skewed_keys(rng, E, B)} for _ in range(n)]


def phase_main_path(K, path, seed):
    """Phases 3, 3 (RESCAL) and 7: the path's step at full width through
    the PM: the fill, warmup, then STEPS steps of intent -> step -> sync
    round -> advance_clock, the launches of every step checked against
    the path's; a profiled window of 4 steps after timing. Peak memory
    from the fill on."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv, w, runner = path.build(seed)
    fill_s = time.perf_counter() - t0
    batches = path.batches(np.random.default_rng(seed), 4)
    intents = [np.unique(np.concatenate(list(b.values()))) for b in batches]

    def pm_step(i):
        nxt = (i + 1) % len(batches)
        w.intent(intents[nxt], w.current_clock + 1, w.current_clock + 2)
        loss = runner(batches[i % len(batches)], None, path.lr)
        srv.drive_rounds()
        w.advance_clock()
        return loss

    first = float(pm_step(0))
    for i in range(1, WARMUP + 1):
        pm_step(i)
    torch.cuda.synchronize()
    losses, steps = [], []
    t0 = time.perf_counter()
    for i in range(WARMUP + 1, WARMUP + 1 + STEPS):
        before = dict(K.LAUNCHES)
        losses.append(pm_step(i))
        steps.append({k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES})
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / STEPS
    want = {**dict.fromkeys(K.LAUNCHES, 0), **path.launches}
    bad = [(i, st) for i, st in enumerate(steps) if st != want]
    check(not bad, f"{path.phase}: steps launched {bad[:2]}, expected "
          f"{path.launches} on every step")
    # the last step trains batch 0 again: its loss must have fallen
    check((WARMUP + 1 + STEPS) % len(batches) == 0, "last step batch")
    last = float(pm_step(WARMUP + 1 + STEPS))
    losses = [float(x) for x in losses]
    # where the step's time goes: a short profiled window after timing
    prof = device_breakdown(lambda i: pm_step(WARMUP + 2 + STEPS + i), 4)
    check(np.isfinite(losses).all() and np.isfinite([first, last]).all(),
          f"{path.phase}: non-finite loss on the main path")
    check(last < first, f"{path.phase}: loss did not fall: first {first}, "
          f"last {last}")
    check(not runner._shard_has_replicas(),
          f"{path.phase}: main path expected no replicas")
    check(all(bool(torch.isfinite(st.main).all()) for st in srv.stores),
          f"{path.phase}: non-finite parameters")
    out = dict(fill_s=fill_s, ms_per_step=dt * 1e3, per_s=path.B / dt,
               first_loss=first, last_loss=last, per_step=steps[0],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               profile=prof)
    srv.shutdown()
    torch.cuda.empty_cache()
    return out


def phase_scan(K, path, seed):
    """Phases 3, 3 (RESCAL) and 7, run_scan: the path's runner on two
    servers filled alike. Server A takes 16 sequential steps, server B
    two windows of SCAN_K (the first runs eagerly and is captured, the
    second replays the graph): losses and the main pools of every class
    must be bitwise equal. Then A takes 32 more eager steps and B 4
    windows, each timed on the host clock up to a synchronize, and one
    window of B is profiled: its trace must hold SCAN_K launches of the
    model kernel, of K1 and of K3's two kernels SCAN_K times the step's
    (one a class), and none of K2. Launch counts: B's, from 0 before its first
    window, the wrappers' (the eager first window) apart from the
    replay's (kernels.REPLAYED)."""
    rng = np.random.default_rng(seed)
    n_eq = 2 * SCAN_K
    batches = path.batches(rng, n_eq + SCAN_TIMED * SCAN_K + SCAN_K)
    srv_a, _, run_a = path.build(seed)
    seq = torch.stack([run_a(b, None, path.lr) for b in batches[:n_eq]])
    main_a = [st.main.clone() for st in srv_a.stores]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[n_eq:n_eq + SCAN_TIMED * SCAN_K]:
        run_a(b, None, path.lr)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / (SCAN_TIMED * SCAN_K)
    srv_a.shutdown()
    del srv_a, run_a
    torch.cuda.empty_cache()

    srv_b, _, run_b = path.build(seed)
    K.reset_launches()
    win = torch.cat([run_b.run_scan(batches[i:i + SCAN_K], None, path.lr)
                     for i in range(0, n_eq, SCAN_K)])
    torch.cuda.synchronize()
    launches, replayed = dict(K.LAUNCHES), dict(K.REPLAYED)
    check(torch.equal(win.view(torch.int32), seq.view(torch.int32)),
          f"{path.phase}: run_scan losses differ from sequential steps: "
          f"{win.tolist()} vs {seq.tolist()}")
    check(all(torch.equal(st.main.view(torch.int32), m.view(torch.int32))
              for st, m in zip(srv_b.stores, main_a)),
          f"{path.phase}: run_scan's main pools differ from sequential "
          "steps' (bitwise)")
    del main_a
    check(all(launches[k] + replayed[k] == n_eq * path.launches[k]
              for k in path.launches),
          f"{path.phase}: run_scan launches {launches}, replayed "
          f"{replayed}, expected {path.launches} per step")
    t0 = time.perf_counter()
    for i in range(SCAN_TIMED):
        lo = n_eq + i * SCAN_K
        run_b.run_scan(batches[lo:lo + SCAN_K], None, path.lr)
    torch.cuda.synchronize()
    scan_ms = (time.perf_counter() - t0) * 1e3 / (SCAN_TIMED * SCAN_K)
    lo = n_eq + SCAN_TIMED * SCAN_K
    k1, k3 = (SCAN_K * path.launches[k] for k in ("routed_gather",
                                                  "ordered_scatter_add"))
    want = {"routed_gather_kernel": k1, path.kernel: SCAN_K,
            "flat_targets_kernel": k3, "ordered_fold_kernel": k3,
            "adagrad_update_kernel": 0}
    # a trace that lost a record (kernel_ms) is taken again, up to four
    # times: lost records only ever make a count short
    for attempt in range(5):
        prof = device_breakdown(
            lambda i: run_b.run_scan(batches[lo:lo + SCAN_K], None,
                                     path.lr), 1)
        check(prof is not None, f"{path.phase}: run_scan: the profiler "
              "recorded no device time, so the replay's kernels cannot "
              "be checked")
        seen = {k: prof["counts"].get(k, 0) for k in want}
        if all(seen[k] >= want[k] for k in want):
            break
        TRACE_RETAKES["run_scan"] = TRACE_RETAKES.get("run_scan", 0) + 1
    check(seen == want, f"{path.phase}: run_scan: a replayed window ran "
          f"{seen} in the trace, expected {want}")
    for k in ("wall_ms_per_step", "device_ms_per_step",
              "device_ops_per_step"):          # one window of SCAN_K steps
        prof[k] /= SCAN_K
    prof["top_ms_per_step"] = [(n, v / SCAN_K)
                               for n, v in prof["top_ms_per_step"]]
    out = dict(ms_per_step=scan_ms, eager_ms_per_step=eager_ms,
               per_s=path.B / scan_ms * 1e3, captures=run_b.graph_captures,
               launches=launches, replayed=replayed, replay_trace=seen,
               losses=win.tolist(), profile=prof)
    srv_b.shutdown()
    torch.cuda.empty_cache()
    return out


def replica_run(at, dev, rng_seed):
    """Phase 4 body on `dev`: two shards, competing intents, fused steps
    with injected negatives in the replica variant, sync merges, then an
    add-only push/pull/set/sync sequence. Returns (pools, reads, runner)."""
    from adapm_tpu_torch.models import make_kge_loss
    from adapm_tpu_torch.ops.fused import DeviceRoutedRunner
    e, r, d, b, n = 512, 16, 8, 64, 4
    rng = np.random.default_rng(rng_seed)
    srv = at.setup(e + r, 4 * d, num_shards=2, num_workers=2, device=dev,
                   opts=at.SystemOptions(sync_max_per_sec=0,
                                         cache_slots_per_shard=256))
    w0, w1 = srv.make_worker(0), srv.make_worker(1)
    vals = rng.normal(size=(e + r, 4 * d)).astype(np.float32) * 0.1
    vals[:, 2 * d:] = 1e-6
    w0.wait(w0.set(np.arange(e + r), vals))
    hot = np.arange(0, e + r, 2)
    # worker 1 first (keys move to shard 1), then worker 0 competes:
    # shard 0 ends up holding replicas
    w1.intent(hot, 0, 10_000)
    srv.wait_sync()
    w0.intent(hot, 0, 10_000)
    srv.wait_sync()
    roles = ("s", "r", "o", "neg")
    runner = DeviceRoutedRunner(
        srv, make_kge_loss("complex"), role_class=dict.fromkeys(roles, 0),
        role_dim=dict.fromkeys(roles, 2 * d), shard=0)
    from adapm_tpu_torch.ops import kernels as K
    step_launches = []
    for step in range(6):
        batch = {"s": rng.integers(0, e, b), "r": rng.integers(e, e + r, b),
                 "o": rng.integers(0, e, b),
                 "neg": rng.integers(0, e, (b, n))}
        before = dict(K.LAUNCHES)
        runner(batch, None, 0.1)
        step_launches.append({k: K.LAUNCHES[k] - before[k]
                              for k in REPLICA_STEP_LAUNCHES})
        srv.sync.run_round(all_channels=True)
    pools = [t.detach().cpu().clone() for t in
             (srv.stores[0].main, srv.stores[0].cache, srv.stores[0].delta)]
    # add-only sequence from one exactly known state (the fused steps'
    # model math may differ in the last bits between devices): flush,
    # then a set from each worker (a set refreshes the writer's own
    # replicas), then pushes with duplicates from both workers, pulls,
    # sets, sync rounds, quiesce
    srv.quiesce()
    for w in (w0, w1):
        w.wait(w.set(np.arange(e + r), vals))
    reads = []
    for step in range(12):
        k = rng.integers(0, e + r, 40)
        v = rng.normal(size=(40, 4 * d)).astype(np.float32)
        wk = (w0, w1)[step % 2]
        wk.wait(wk.push(k, v))
        if step % 3 == 2:
            wk.wait(wk.set(k[:8], v[:8]))
        if step % 4 == 3:
            srv.sync.run_round(all_channels=True)
        reads.append(wk.pull_sync(k))
    srv.quiesce()
    reads.append(w0.pull_sync(np.arange(e + r)))
    reads.append(w1.pull_sync(np.arange(e + r)))
    has_rep = runner._shard_has_replicas()
    srv.shutdown()
    return pools, reads, has_rep, step_launches


def phase_replicas(at, K, dev):
    before = dict(K.LAUNCHES)
    pools_g, reads_g, rep_g, steps_g = replica_run(at, dev, 7)
    used = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
    check(rep_g, "the replica phase held no replicas on the runner's shard")
    check(all(used[k] > 0 for k in STEP_KERNELS),
          f"replica phase skipped a kernel: {used}")
    check(used["gather_pool"] == 0, "the replica phase launched K8")
    check(all(s == REPLICA_STEP_LAUNCHES for s in steps_g),
          f"replica-step launches {steps_g}, expected "
          f"{REPLICA_STEP_LAUNCHES} per step")
    pools_c, reads_c, _, _ = replica_run(at, "cpu", 7)
    for a, b_ in zip(pools_g, pools_c):
        check(torch.allclose(a, b_, rtol=1e-5, atol=1e-6),
              "fused steps on cuda and cpu differ beyond rtol 1e-5 / "
              "atol 1e-6")
    for i, (a, b_) in enumerate(zip(reads_g, reads_c)):
        check(np.array_equal(a.view(np.uint32), b_.view(np.uint32)),
              f"add-only read {i} differs between cuda and cpu")
    return used


def background_faults(srv):
    """What the background programs of a server hid: prefetch passes,
    tier maintenance passes and background planner rounds that raised
    (each logged and retried), executor programs that failed and
    executor retries."""
    ex = srv.exec.stats()
    out = {"prefetch_failures": 0 if srv.prefetch is None
           else srv.prefetch.failures,
           "tier_failures": 0 if srv.tier is None
           else srv.tier.engine.failures,
           "sync_loop_failures": srv.sync_loop_failures,
           "programs_failed": ex["programs_failed"],
           "retries": ex["retries"]}
    return {k: v for k, v in out.items() if v}


# background failures of every server shut down during the run; main()
# fails the run when any is recorded
BACKGROUND_FAULTS = []


def watch_background(at):
    """Record every server's background failures at its shutdown (apps
    shut their own servers down inside run_app)."""
    orig = at.Server.shutdown

    def shutdown(self):
        out = orig(self)
        # a server with a fault plane fails and retries by design: phase
        # 14 checks its faults fired and were retried
        faults = background_faults(self) if self.fault is None else {}
        if faults:
            BACKGROUND_FAULTS.append(faults)
        return out

    at.Server.shutdown = shutdown


def check_background(srv, what):
    faults = background_faults(srv)
    check(not faults, f"{what}: background work failed: {faults}")


def pipeline_flow(at, K, dev, seed, prefetch, stage_keys):
    """Phase 3 (pipeline) on one server: phase 3's table and runner with
    the prefetch pipeline on (the default) or off (prefetch=False:
    inline rounds), and with each step's keys pre-uploaded as StagedKeys
    on its intent path (`stage_keys`, as the app does at --scan_steps 1
    with the pipeline on) or uploaded in the dispatch. WARMUP + STEPS
    eager steps of intent -> step ->
    drive_rounds -> advance_clock, a profiled window of PROF_STEPS more
    and one step, then
    SCAN_TIMED run_scan windows of SCAN_K, each followed by its
    drive_rounds(SCAN_K) and clock ticks, with the next window's intents
    declared before it."""
    srv, w, runner = kge_server(at, dev, seed, prefetch=prefetch)
    rng = np.random.default_rng(seed)
    batches = kge_batches(rng, 4)
    windows = [kge_batches(rng, SCAN_K) for _ in range(SCAN_TIMED + 1)]
    intents = [np.unique(np.concatenate(list(b.values()))) for b in batches]
    staged = {}
    # the training thread's host seconds by part of a step
    parts = {"intent": [], "keys": [], "call": [], "rounds": []}

    def prepare(i):
        t0 = time.perf_counter()
        w.intent(intents[i % 4], w.current_clock + 1, w.current_clock + 2)
        t1 = time.perf_counter()
        if stage_keys:
            staged[i] = runner.prefetch_keys(batches[i % 4])
        return t0, t1, time.perf_counter()

    def step(i):
        t0, t1, t2 = prepare(i + 1)
        loss = runner(batches[i % 4], None, 0.1, staged=staged.pop(i, None))
        t3 = time.perf_counter()
        srv.drive_rounds()
        t4 = time.perf_counter()
        for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[k].append(dt)
        w.advance_clock()
        return loss

    prepare(0)
    losses = [step(i) for i in range(WARMUP)]
    torch.cuda.synchronize()
    per_step = []
    t0 = time.perf_counter()
    for i in range(WARMUP, WARMUP + STEPS):
        before = dict(K.LAUNCHES)
        losses.append(step(i))
        per_step.append({k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES})
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    part_ms = {k: float(np.median(v[WARMUP:])) * 1e3
               for k, v in parts.items()}
    prof = device_breakdown(lambda j: step(WARMUP + STEPS + j), PROF_STEPS)
    losses.append(step(WARMUP + STEPS + PROF_STEPS))
    # the windows: the first captures the graph, the rest replay it
    t_win = []
    for wi, win in enumerate(windows):
        for b in windows[wi + 1] if wi + 1 < len(windows) else ():
            w.intent(np.unique(np.concatenate(list(b.values()))),
                     w.current_clock + SCAN_K, w.current_clock + 2 * SCAN_K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(runner.run_scan(win, None, 0.1))
        srv.drive_rounds(SCAN_K)
        for _ in range(SCAN_K):
            w.advance_clock()
        torch.cuda.synchronize()
        t_win.append(time.perf_counter() - t0)
    scan_ms = float(np.mean(t_win[1:])) * 1e3 / SCAN_K
    report, passes, pass_ms = None, None, None
    if prefetch:
        srv.prefetch.flush()
        report = {k: int(v) for k, v in srv.prefetch.report().items()}
        # the pipeline's passes, timed by the scheduler around each pass
        # on its own thread (host wall clock, lock waits included)
        passes = srv.prefetch.passes
        pass_ms = srv.prefetch.pass_s * 1e3 / max(1, passes)
    out = dict(losses=torch.cat([x.reshape(-1) for x in losses]),
               main=srv.stores[0].main.clone(), eager_ms=eager_ms,
               part_ms=part_ms, passes=passes, pass_ms=pass_ms,
               scan_ms=scan_ms,
               profile=prof,
               per_step=per_step, captures=runner.graph_captures,
               staged_steps=runner.staged_steps, report=report,
               rounds=int(srv.sync.stats.rounds),
               topology_version=srv.topology_version)
    check_background(srv, f"phase 3 (pipeline {'on' if prefetch else 'off'})")
    srv.shutdown()
    return out


def phase_pipeline(at, K, dev):
    """Phase 3 with the prefetch pipeline on (keys staged) and off from
    one fill, and off with the keys staged (StagedKeys without the
    pipeline's passes), in turns (on, off, off with keys staged): every
    run's losses (eager steps and windows) and whole
    main pool bitwise the first's (S=1: every key is the worker's own,
    so delegated rounds move nothing), the same launches every eager
    step, one graph capture per signature on each."""
    runs, ref, launches_on = [], None, None
    want = {**dict.fromkeys(K.LAUNCHES, 0), **STEP_LAUNCHES}
    turns = [(True, True), (False, False), (False, True)]
    for prefetch, stage_keys in turns:
        name = "on" if prefetch else (
            "off, keys staged" if stage_keys else "off")
        K.reset_launches()
        r = pipeline_flow(at, K, dev, 11, prefetch, stage_keys)
        if launches_on is None:
            launches_on = dict(K.LAUNCHES)
        bad = [st for st in r["per_step"] if st != want]
        check(not bad, f"phase 3 (pipeline {name}): steps launched "
              f"{bad[:2]}, expected {STEP_LAUNCHES}")
        check(r["captures"] == 1, f"phase 3 (pipeline {name}): "
              f"{r['captures']} graph captures for one signature")
        if ref is None:
            ref = r["losses"], r["main"]
        else:
            check(torch.equal(r["losses"].view(torch.int32),
                              ref[0].view(torch.int32)),
                  "phase 3: losses with the pipeline differ from "
                  "--sys.prefetch 0")
            check(torch.equal(r["main"].view(torch.int32),
                              ref[1].view(torch.int32)),
                  "phase 3: the main pool with the pipeline differs from "
                  "--sys.prefetch 0 (bitwise)")
        del r["main"], r["losses"], r["per_step"]
        if prefetch:
            check(r["report"]["rounds_driven"] > 0,
                  "phase 3: the pipeline drove no planner round")
        check(r["staged_steps"] == stage_keys * (
            WARMUP + STEPS + PROF_STEPS + 1),
              f"phase 3 (pipeline {name}): {r['staged_steps']} steps took "
              "StagedKeys")
        runs.append((name, r))
    del ref
    check_launched(launches_on, "phase 3 (pipeline on)", STEP_KERNELS)
    return dict(runs=runs, launches_on=launches_on)


def report_pipeline(pp, smi):
    for name, r in pp["runs"]:
        prof = r["profile"]
        busy = "not measured" if prof is None else (
            f"{prof['device_ops_per_step']:.1f} device operations/step, "
            f"device {prof['device_ms_per_step']:.3f} ms/step, busy "
            f"{prof['busy_share']:.3f}")
        pm = r["part_ms"]
        passes = "" if r["pass_ms"] is None else (
            f"; {r['passes']} pipeline passes, {r['pass_ms']:.3f} ms "
            "each on their thread")
        print(f"phase 3 (pipeline {name}): eager {r['eager_ms']:.3f} "
              f"ms/step (host medians: intent {pm['intent']:.3f}, key "
              f"staging {pm['keys']:.3f}, step call {pm['call']:.3f}, "
              f"drive_rounds {pm['rounds']:.3f} ms{passes}), "
              f"K={SCAN_K} windows {r['scan_ms']:.3f} ms/step, {busy}, "
              f"graph captures {r['captures']}, staged-key steps "
              f"{r['staged_steps']}, planner rounds {r['rounds']}, "
              f"prefetch.report() {r['report']} [{smi}]", flush=True)
    print("phase 3 (pipeline): losses and main pool bitwise equal on and "
          "off; launches per step unchanged", flush=True)


def pull_flow(at, K, dev, prefetch):
    """Phase 11 on one server: phase 3's table, one worker, PULL_BATCHES
    batches of 4,096 zipf keys (each the unique sorted batch its intent
    names): intent for batch i + 2 -> pull batch i -> push small deltas
    to it -> advance_clock, prefetch_pull "auto". Then the
    read-your-writes check: a batch staged (its intent, flush), a push
    to its keys, its pull."""
    srv, w = kge_table(at, dev, 13, prefetch=prefetch,
                       prefetch_pull="auto")
    rng = np.random.default_rng(17)
    bs = [np.unique(skewed_keys(rng, E + R, B))
          for _ in range(PULL_BATCHES + 3)]
    deltas = [rng.normal(size=(len(b), L)).astype(np.float32) * 1e-3
              for b in bs]
    for i in (0, 1):
        w.intent(bs[i], w.current_clock + i, w.current_clock + i)
    pulls, lat = [], []
    K.reset_launches()
    for i in range(PULL_BATCHES):
        w.intent(bs[i + 2], w.current_clock + 2, w.current_clock + 2)
        t0 = time.perf_counter()
        got = w.pull_sync(bs[i])
        lat.append(time.perf_counter() - t0)
        pulls.append(got)
        w.wait(w.push(bs[i], deltas[i]))
        w.advance_clock()
    report = None
    if prefetch:
        srv.prefetch.flush()
        report = {k: int(v) for k, v in srv.prefetch.report().items()}
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    # a staged batch nothing wrote: its pull must be a staged hit; then
    # read-your-writes through a staged buffer: the batch staged again,
    # a push to its keys, its pull. Two clock ticks first, so the flow's
    # last staged batches expire and x's is the one live
    x = bs[PULL_BATCHES + 2]
    for _ in range(2):
        w.advance_clock()

    def stage():
        w.intent(x, w.current_clock, w.current_clock + 4)
        if prefetch:
            srv.prefetch.flush()
            check(srv.prefetch.report()["live"] == 1,
                  "phase 11: the intended batch is not the one staged")

    stage()
    hits0 = srv.prefetch.stats["hits"] if prefetch else 0
    before = w.pull_sync(x)
    if prefetch:
        check(srv.prefetch.stats["hits"] == hits0 + 1,
              "phase 11: the pull of a staged batch nothing wrote was "
              "not a staged hit")
    stage()
    inv0 = srv.prefetch.stats["invalidated_write"] if prefetch else 0
    w.wait(w.push(x, deltas[PULL_BATCHES + 2]))
    if prefetch:
        check(srv.prefetch.stats["invalidated_write"] > inv0,
              "phase 11: a push to staged keys invalidated nothing")
    after = w.pull_sync(x)
    out = dict(pulls=pulls, after=after, before=before, lat=lat,
               launches=launches, report=report,
               final_report=None if not prefetch else {
                   k: int(v) for k, v in srv.prefetch.report().items()})
    check_background(srv, f"phase 11 (pipeline {'on' if prefetch else 'off'})")
    srv.shutdown()
    return out


def phase_pull_flow(at, K, dev):
    """Phase 11: the pull-driven flow with the pipeline on and off; every
    pull bitwise the other flow's, the staged read-your-writes pull
    bitwise its plain counterpart."""
    on = pull_flow(at, K, dev, True)
    off = pull_flow(at, K, dev, False)
    for i, (a, b) in enumerate(zip(on["pulls"], off["pulls"])):
        check(np.array_equal(a.view(np.uint32), b.view(np.uint32)),
              f"phase 11: pull {i} with the pipeline differs from "
              "--sys.prefetch 0")
    check(on["final_report"]["hits"] > 0, "phase 11: no staged hit")
    check(np.array_equal(on["before"].view(np.uint32),
                         off["before"].view(np.uint32)),
          "phase 11: the staged hit differs from the plain flow's pull")
    check(np.array_equal(on["after"].view(np.uint32),
                         off["after"].view(np.uint32)),
          "phase 11: the pull after a push to staged keys differs from "
          "the plain flow's")
    check(not np.array_equal(off["after"], off["before"]),
          "phase 11: the read-your-writes push changed nothing")
    rep = on["report"]
    hits = rep["hits"]
    plain_pulls = PULL_BATCHES - hits
    staging_k1 = on["launches"]["routed_gather"] - plain_pulls
    # every staging (restages included: each also counts as staged) is
    # one K1 launch of the one length class
    check(staging_k1 == rep["staged"],
          f"phase 11: {staging_k1} K1 launches outside plain pulls, "
          f"{rep['staged']} stagings")
    check(off["launches"]["routed_gather"] == PULL_BATCHES,
          f"phase 11: the plain flow launched K1 "
          f"{off['launches']['routed_gather']} times in {PULL_BATCHES} "
          "pulls")
    for r, name in ((on, "on"), (off, "off")):
        check_launched(r["launches"], f"phase 11 (pipeline {name})",
                       ("routed_gather", "ordered_scatter_add"))
    pct = {name: [float(np.percentile(r["lat"], q)) * 1e3 for q in (50, 99)]
           for name, r in (("on", on), ("off", off))}
    return dict(report=rep, hit_rate=hits / PULL_BATCHES, pct_ms=pct,
                final_report=on["final_report"],
                staging_k1=staging_k1, launches_on=on["launches"],
                launches_off=off["launches"])


def planner_run(at, dev, compress="off"):
    """Phase 12 body on `dev`: phase 4's two-shard replica setup, the
    background planner on (start_sync_thread), two worker threads each
    pushing PLANNER_RUNS integer-valued updates to zipf keys of a hot set
    both declare intents for (competing intents: replicas), then
    WaitSync -> Barrier -> WaitSync, stop_sync_thread(), quiesce().
    Returns (every main row, the sequential sum, rounds/s, replicas
    created, the sync section's wire bytes). `compress` is
    --sys.sync.compress."""
    import threading
    e, r, d = 512, 16, 8
    n = e + r
    srv = at.setup(n, 4 * d, num_shards=2, num_workers=2, device=dev,
                   opts=at.SystemOptions(sync_max_per_sec=2000.0,
                                         cache_slots_per_shard=256,
                                         sync_report_s=0,
                                         sync_compress=compress))
    ws = [srv.make_worker(i) for i in range(2)]
    init = np.random.default_rng(3).integers(
        -4, 5, size=(n, 4 * d)).astype(np.float32)
    ws[0].wait(ws[0].set(np.arange(n), init))
    hot = np.arange(0, n, 3)
    sums = [np.zeros((n, 4 * d), np.float64) for _ in ws]
    errors = []

    def run(w):
        rng = np.random.default_rng(100 + w.worker_id)
        try:
            for i in range(PLANNER_RUNS):
                if i % 25 == 0:
                    w.intent(hot, w.current_clock, w.current_clock + 40)
                k = hot[(len(hot) * rng.random(32) ** 2).astype(np.int64)]
                v = rng.integers(-3, 4, size=(32, 4 * d)).astype(np.float32)
                w.push(k, v)
                np.add.at(sums[w.worker_id], k, v)
                if i % 8 == 0:
                    w.wait_all()
                w.advance_clock()
            w.wait_all()
        except Exception as ex:  # noqa: BLE001 - surface to main thread
            errors.append(f"worker {w.worker_id}: {type(ex).__name__}: {ex}")

    t0 = time.perf_counter()
    r0 = srv.sync.stats.rounds
    srv.start_sync_thread()
    threads = [threading.Thread(target=run, args=(w,)) for w in ws]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        check(not t.is_alive(), "phase 12: a worker thread hung")
    check(not errors, f"phase 12: {errors}")
    srv.wait_sync()
    srv.barrier()
    srv.wait_sync()
    srv.stop_sync_thread()
    rounds_s = (srv.sync.stats.rounds - r0) / (time.perf_counter() - t0)
    srv.quiesce()
    got = srv.read_main(np.arange(n)).reshape(n, 4 * d)
    want = (init + sums[0] + sums[1]).astype(np.float32)
    created = int(srv.sync.stats.replicas_created)
    sync = srv.metrics_snapshot()["sync"]
    nbytes = {k: sync[k] for k in ("bytes_shipped", "bytes_full_equiv",
                                   "bytes_per_round", "ef_residual_norm")}
    nbytes["rounds"] = int(srv.sync.stats.rounds)
    check_background(srv, f"phase 12 ({dev})")
    srv.shutdown()
    return got, want, rounds_s, created, nbytes


def phase_planner(at, K, dev):
    K.reset_launches()
    got_g, want, rounds_g, created, nbytes = planner_run(at, dev)
    launches = dict(K.LAUNCHES)
    check(np.array_equal(got_g.view(np.uint32), want.view(np.uint32)),
          "phase 12: after the background planner and quiesce the main "
          "rows differ from the sequential sum")
    check(created > 0, "phase 12: competing intents created no replica")
    check_launched(launches, "phase 12", ("routed_gather",
                                          "ordered_scatter_add",
                                          "sync_round", "drop_set"))
    got_c, _, rounds_c, _, _ = planner_run(at, "cpu")
    check(np.array_equal(got_g.view(np.uint32), got_c.view(np.uint32)),
          "phase 12: cuda and cpu differ")
    return dict(rounds_s=rounds_g, rounds_s_cpu=rounds_c,
                replicas_created=created, launches=launches, **nbytes)


APP_ARGS = ["--model", "complex", "--dim", str(D_MODEL), "--neg_ratio",
            str(N), "--batch_size", str(B), "--synthetic_mode", "lowrank",
            "--synthetic_entities", str(E), "--synthetic_relations", str(R),
            "--eval_chunk", str(EVAL_CHUNK), "--sys.sync.max_per_sec", "0"]
OFF = ["--sys.prefetch", "0"]         # the pipeline's kill switch
# test_apps.py test_kge_app's configuration, on 8 virtual shards
SMALL_ARGS = ["--model", "complex", "--dim", "8", "--neg_ratio", "2",
              "--synthetic_entities", "60", "--synthetic_relations", "4",
              "--synthetic_triples", "400", "--epochs", "6",
              "--batch_size", "32", "--lr", "0.2", "--eval_every", "6",
              "--eval_triples", "60", "--no-device_routes",
              "--num_shards", "8", "--sys.sync.max_per_sec", "0",
              "--sys.prefetch", "0"]


def run_app(app, K, argv, dev=None, profile=False):
    """An app as main(argv) runs it (parse, then run_app), with the launch
    counts set to 0 just before and read just after (the wrappers'
    returned, the graph replays' in res["replayed"]). `profile=True`
    traces the run's device activity (CUDA only: no host events) and
    adds its device seconds and busy share of the epochs' wall time."""
    args = app.build_parser().parse_args(argv)
    K.reset_launches()
    if not profile:
        res = app.run_app(args, device=dev)
    else:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as trace
        with trace(activities=[ProfilerActivity.CUDA]) as prof:
            res = app.run_app(args, device=dev)
        dev_s = sum(ev.self_device_time_total for ev in prof.key_averages()
                    if ev.device_type == torch.autograd.DeviceType.CUDA
                    ) / 1e6
        # None: the trace recorded no device time (not measured)
        res["device_s"] = dev_s or None
        res["busy_share"] = dev_s / sum(res["epoch_s"]) if dev_s else None
    res["replayed"] = dict(K.REPLAYED)
    return res, dict(K.LAUNCHES)


def check_app(res, launches, what, kernels):
    losses = res["epoch_losses"]
    check(np.isfinite(losses).all(), f"{what}: non-finite loss {losses}")
    check(0 < res["mrr"] <= 1, f"{what}: MRR {res['mrr']} outside (0, 1]")
    check_launched(launches, what, kernels)


def check_launched(launches, what, kernels, allowed=()):
    """Each of the path's kernels launched, and no kernel another path
    owns but those `allowed` (launched or not): K2 only where a step's
    negatives are a shared [N] batch, K5 only on ComplEx paths, K16 only
    on RESCAL's, K6 only on word2vec's, K7 only on MF's, K8 only on the
    bag-serving paths,
    K9-K11 only on tiered paths, K12 only on compressed sync rounds."""
    missing = [k for k in kernels if launches[k] == 0]
    check(not missing, f"{what}: kernels never launched: {missing}")
    other = {k: launches[k] for k in OWNED_KERNELS
             if k not in kernels and k not in allowed and launches[k]}
    check(not other, f"{what}: other paths' kernels launched: {other}")


class HostClock:
    """Host seconds spent inside chosen functions (wrapped for the
    duration of a `with` block): where an app run's wall clock goes."""

    def __init__(self, targets):
        self.targets = targets  # [(owner, attribute name, label)]
        self.calls = {label: [] for _, _, label in targets}  # seconds

    @property
    def seconds(self):
        return {label: sum(t) for label, t in self.calls.items()}

    def __enter__(self):
        self.saved = []
        for owner, name, label in self.targets:
            fn = getattr(owner, name)
            self.saved.append((owner, name, fn))

            def wrapped(*a, _fn=fn, _label=label, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.calls[_label].append(time.perf_counter() - t0)
            setattr(owner, name, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)


class EpochTrace:
    """The device busy share of one training epoch of an app run: a
    CUDA-only profiler started at the epoch's first step call (a
    DeviceRoutedRunner call or run_scan window, after a synchronize) and
    stopped at its epoch report (its losses are on the host by then),
    with the host clock over the same span. Setup, generation and eval
    stay outside the trace."""

    def __init__(self, app, epoch):
        self.app, self.epoch = app, epoch
        self.reports, self.prof, self.t0, self.wall = 0, None, None, None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        from adapm_tpu_torch.ops.fused import DeviceRoutedRunner as DR
        self.saved = [(DR, "__call__", DR.__call__),
                      (DR, "run_scan", DR.run_scan),
                      (self.app, "epoch_report", self.app.epoch_report)]

        def start():
            if self.prof is None and self.reports == self.epoch:
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.t0 = time.perf_counter()

        def step(fn):
            def wrapped(*a, **kw):
                start()
                return fn(*a, **kw)
            return wrapped

        def report(*a, **kw):
            if self.prof is not None and self.wall is None:
                torch.cuda.synchronize()
                self.wall = time.perf_counter() - self.t0
                self.prof.__exit__(None, None, None)
            self.reports += 1
            return self.saved[2][2](*a, **kw)

        DR.__call__ = step(self.saved[0][2])
        DR.run_scan = step(self.saved[1][2])
        self.app.epoch_report = report
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)

    def result(self):
        """{"traced_epoch_s", "device_s", "busy_share"}; None where the
        trace recorded no device time (not measured)."""
        if self.wall is None:
            return dict(traced_epoch_s=None, device_s=None, busy_share=None)
        dev_s = sum(ev.self_device_time_total
                    for ev in self.prof.key_averages()
                    if ev.device_type == torch.autograd.DeviceType.CUDA
                    ) / 1e6
        return dict(traced_epoch_s=self.wall, device_s=dev_s or None,
                    busy_share=dev_s / self.wall if dev_s else None)


def phase_app(K):
    """Phase 5: the app at full width, device routes, 2 epochs."""
    from adapm_tpu_torch.apps import knowledge_graph_embeddings as kge
    from adapm_tpu_torch.core.sync import SyncManager
    from adapm_tpu_torch.io import kge as kgeio
    from adapm_tpu_torch.ops.fused import DeviceRoutedRunner
    argv = APP_ARGS + ["--synthetic_triples", str(100 * B), "--epochs", "2",
                       "--eval_every", "1", "--eval_triples", "100",
                       "--scan_steps", str(SCAN_K)]
    torch.cuda.reset_peak_memory_stats()
    clock = HostClock([
        (kgeio, "_generate_lowrank_device", "generate (total)"),
        (kgeio.TripleDataset, "filters", "TripleDataset.filters"),
        (kge.KgeRun, "init_model", "init_model"),
        (DeviceRoutedRunner, "__call__", "fused step call"),
        (DeviceRoutedRunner, "run_scan", "run_scan window call"),
        (SyncManager, "run_round", "sync round"),
        (kge, "_pool_counts", "eval device counts"),
        (kge, "_filter_correct", "eval filter correction")])
    with clock, EpochTrace(kge, epoch=1) as trace:
        res, launches = run_app(kge, K, argv)
    res["host_seconds"] = clock.seconds
    check_app(res, launches, "phase 5", APP_KERNELS)
    losses = res["epoch_losses"]
    check(losses[1] < losses[0], f"phase 5: loss did not fall: {losses}")
    check(res["replicas_created"] == 0,
          f"phase 5: {res['replicas_created']} replicas at S=1")
    steps = 2 * 100
    check(launches["complex_step"] + res["replayed"]["complex_step"]
          == steps, f"phase 5: K5 launched {launches['complex_step']} "
          f"times and replayed {res['replayed']['complex_step']} times "
          f"in {steps} steps")
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["traced"] = trace.result()
    # the same run with the kill switch (on above, then off; one turn,
    # cut from three to keep the run's time with phase 13), its second
    # epoch traced for the busy share: at S=1 the pipeline moves
    # nothing, so every epoch loss is bitwise the same
    turns = [dict(pipeline="on", epoch_s=res["epoch_s"],
                  eval_s=res["eval_s"], **res["traced"])]
    for name in ("off",):
        with EpochTrace(kge, epoch=1) as tr:
            r, ln = run_app(kge, K, argv + (OFF if name == "off" else []))
        check_app(r, ln, f"phase 5 (pipeline {name})", APP_KERNELS)
        check(np.array_equal(np.float64(r["epoch_losses"]),
                             np.float64(losses)),
              f"phase 5: epoch losses {r['epoch_losses']} (pipeline "
              f"{name}) differ from the first run's {losses}")
        check(ln == launches, f"phase 5: launches {ln} (pipeline {name}), "
              f"{launches} in the first run")
        turns.append(dict(pipeline=name, epoch_s=r["epoch_s"],
                          eval_s=r["eval_s"], **tr.result()))
    res["turns"] = turns
    # per-step device routes (--scan_steps 1): the path where the app
    # pre-uploads each batch's keys as StagedKeys; its one epoch traced
    # for the busy share, both ways
    one = APP_ARGS + ["--synthetic_triples", str(APP_STEPS1 * B),
                      "--epochs", "1", "--eval_every", "0",
                      "--scan_steps", "1"]
    res["scan1"] = {}
    for name, extra in (("on", []), ("off", OFF)):
        with EpochTrace(kge, epoch=0) as tr:
            r, ln = run_app(kge, K, one + extra)
        check(np.isfinite(r["epoch_losses"]).all(),
              f"phase 5 (--scan_steps 1, pipeline {name}): non-finite loss")
        check_launched(ln, f"phase 5 (--scan_steps 1, pipeline {name})",
                       STEP_KERNELS)
        check(ln["complex_step"] == APP_STEPS1,
              f"phase 5 (--scan_steps 1): K5 launched "
              f"{ln['complex_step']} times in {APP_STEPS1} steps")
        check(r["staged_steps"] == (APP_STEPS1 if name == "on" else 0),
              f"phase 5 (--scan_steps 1, pipeline {name}): "
              f"{r['staged_steps']} staged-key steps")
        res["scan1"][name] = dict(epoch_s=r["epoch_s"],
                                  epoch_losses=r["epoch_losses"],
                                  staged_steps=r["staged_steps"],
                                  **tr.result())
    check(np.array_equal(np.float64(res["scan1"]["on"]["epoch_losses"]),
                         np.float64(res["scan1"]["off"]["epoch_losses"])),
          "phase 5 (--scan_steps 1): losses with the pipeline differ from "
          "--sys.prefetch 0")
    return res, launches


def phase_host_routes(K):
    """Phase 6: the host-routed path at full width (10 steps of 131,072
    PullSample negatives), then the small configuration on cuda and cpu."""
    from adapm_tpu_torch.apps import knowledge_graph_embeddings as kge
    argv = APP_ARGS + ["--synthetic_triples", str(10 * B), "--epochs", "1",
                       "--eval_every", "1", "--eval_triples", "100",
                       "--no-device_routes"]
    full, launches = run_app(kge, K, argv)
    check_app(full, launches, "phase 6 (full width)", APP_KERNELS)

    ck_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke_ckpt")
    small = SMALL_ARGS + ["--checkpoint_every", "6", "--checkpoint_dir",
                          ck_dir]
    res_g, _ = run_app(kge, K, small)
    res_c, _ = run_app(kge, K, small, dev="cpu")
    lg, lc = np.array(res_g["epoch_losses"]), np.array(res_c["epoch_losses"])
    check(np.allclose(lg, lc, rtol=1e-4, atol=0),
          f"phase 6: cuda and cpu epoch losses differ beyond rtol 1e-4: "
          f"{lg} vs {lc}")
    check(abs(res_g["mrr"] - res_c["mrr"]) <= 0.02,
          f"phase 6: MRR cuda {res_g['mrr']} vs cpu {res_c['mrr']}")
    # one checkpoint (the cuda run's) evaluated on both devices
    from adapm_tpu_torch.io import kge as kgeio
    args = kge.build_parser().parse_args(
        small + ["--init_from", os.path.join(ck_dir, "kge_epoch5.npz")])
    ds = kgeio.generate_synthetic(60, 4, 400, seed=args.seed)
    t = ds.valid[:60]
    counts = {}
    for dev in ("cuda", "cpu"):
        run = kge.KgeRun(args, ds, device=dev)
        run.init_model()
        counts[dev] = kge._pool_counts(run, t[:, 0], t[:, 1], t[:, 2],
                                       ties=dev == "cpu")
        run.srv.shutdown()
    g_o, g_s = counts["cuda"][:2]
    c_o, c_s, _, t_o, t_s = counts["cpu"]
    check((np.abs(g_o - c_o) <= t_o).all() and (np.abs(g_s - c_s) <= t_s)
          .all(), "phase 6: eval counts of one checkpoint differ between "
          "cuda and cpu beyond the near-tie rule")
    # RESCAL: K16 on the host-routed path
    rescal = SMALL_ARGS + ["--model", "rescal"]
    res_rg, rescal_launches = run_app(kge, K, rescal)
    check_app(res_rg, rescal_launches, "phase 6 (RESCAL)", RESCAL_KERNELS)
    res_rc, _ = run_app(kge, K, rescal, dev="cpu")
    rg, rc = (np.array(r["epoch_losses"]) for r in (res_rg, res_rc))
    check(np.allclose(rg, rc, rtol=1e-4, atol=0),
          f"phase 6: RESCAL cuda and cpu epoch losses differ beyond rtol "
          f"1e-4: {rg} vs {rc}")
    # and on device routes in --scan_steps 2 windows
    rescal_dev = [a for a in rescal if a != "--no-device_routes"] + [
        "--scan_steps", "2"]
    res_rd, rescal_dev_launches = run_app(kge, K, rescal_dev)
    check_app(res_rd, rescal_dev_launches, "phase 6 (RESCAL, device "
              "routes)", RESCAL_KERNELS)
    check(rescal_dev_launches["rescal_step"]
          + res_rd["replayed"]["rescal_step"] > 0
          and res_rd["replayed"]["rescal_step"] > 0,
          "phase 6 (RESCAL, device routes): no K16 launch replayed from a "
          "window's graph")
    shared = phase_shared_negatives(K)
    return dict(full=full, full_launches=launches,
                rescal_launches=rescal_launches,
                rescal_dev_launches=rescal_dev_launches,
                rescal_dev_replayed=res_rd["replayed"],
                rescal_dev_losses=res_rd["epoch_losses"],
                shared_negatives=shared,
                rescal_losses_cuda=rg.tolist(), rescal_losses_cpu=rc.tolist(),
                small_losses_cuda=lg.tolist(), small_losses_cpu=lc.tolist(),
                small_mrr_cuda=res_g["mrr"], small_mrr_cpu=res_c["mrr"],
                count_diff=int(np.abs(g_o - c_o).sum()
                               + np.abs(g_s - c_s).sum()),
                ties=int(t_o.sum() + t_s.sum()))


SHARED_NEG_STEPS = 8


def phase_shared_negatives(K, dev="cuda"):
    """Phase 6's K2 path: a small device-routed RESCAL run (512 entities,
    16 relations, d=8, B=64) whose negatives are one [N] batch of 4
    drawn on the device and shared by a step's triples (neg_shape=(4,);
    the JAX body draws any neg_shape). Neither K5 nor K16 takes that
    shape, so each step runs autograd, then K2 once per trainable role:
    per step one K1 and one K3 a class, four K2, no K16; losses finite."""
    import adapm_tpu_torch as at
    from adapm_tpu_torch.models import make_kge_loss
    from adapm_tpu_torch.ops.fused import DeviceRoutedRunner
    e, r, d, b, n = 512, 16, 8, 64, 4
    rng = np.random.default_rng(17)
    srv = at.setup(e + r, np.array([2 * d] * e + [2 * d * d] * r),
                   device=dev, opts=at.SystemOptions(sync_max_per_sec=0))
    w = srv.make_worker(0)
    for keys, width in ((np.arange(e), d), (np.arange(e, e + r), d * d)):
        vals = rng.normal(size=(len(keys), 2 * width)).astype(np.float32)
        vals *= 0.1
        vals[:, width:] = 1e-6
        w.wait(w.set(keys, vals))
    ec, rc = int(srv.ab.key_class[0]), int(srv.ab.key_class[e])
    runner = DeviceRoutedRunner(
        srv, make_kge_loss("rescal"),
        role_class={"s": ec, "r": rc, "o": ec, "neg": ec},
        role_dim={"s": d, "r": d * d, "o": d, "neg": d}, neg_role="neg",
        neg_shape=(n,), neg_population=np.arange(e), seed=1)
    want = {**dict.fromkeys(K.LAUNCHES, 0), "routed_gather": 2,
            "adagrad_update": 4, "ordered_scatter_add": 2}
    K.reset_launches()
    losses, steps = [], []
    for _ in range(SHARED_NEG_STEPS):
        batch = {"s": rng.integers(0, e, b), "r": rng.integers(e, e + r, b),
                 "o": rng.integers(0, e, b)}
        before = dict(K.LAUNCHES)
        losses.append(float(runner(batch, None, 0.1)))
        steps.append({k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES})
    launches = dict(K.LAUNCHES)
    check(np.isfinite(losses).all(), f"phase 6 (shared negatives): "
          f"non-finite loss {losses}")
    check(all(st == want for st in steps), f"phase 6 (shared negatives): "
          f"steps launched {steps[:2]}, expected {want} on every step")
    check_launched(launches, "phase 6 (shared negatives)",
                   SHARED_NEG_KERNELS)
    srv.shutdown()
    return dict(losses=losses, launches=launches)


def w2v_server(at, dev, seed):
    """bench_w2v's setup on `dev`: 200,000 keys of [emb 128 | adagrad 128],
    a slab fill (normal x 0.05, accumulators 1e-6), and a device-routed
    SGNS runner drawing N negatives per pair from the unigram^0.75 alias
    table of zipf counts 1/(i+10) over the syn1 keys."""
    from adapm_tpu_torch.models.sgns import (build_alias_table, sgns_loss,
                                             syn1_key)
    from adapm_tpu_torch.ops.fused import DeviceRoutedRunner
    nk = 2 * V_W2V
    srv = at.setup(nk, L_W2V, opts=at.SystemOptions(
        cache_slots_per_shard=1, sync_max_per_sec=0), device=dev)
    w = srv.make_worker(0)
    fill = np.random.default_rng(seed)
    for lo in range(0, nk, 100_000):
        hi = min(lo + 100_000, nk)
        vals = fill.normal(size=(hi - lo, L_W2V)).astype(np.float32) * 0.05
        vals[:, D_W2V:] = 1e-6
        w.set(np.arange(lo, hi), vals)
    srv.block()
    roles = ("center", "ctx", "neg")
    runner = DeviceRoutedRunner(
        srv, sgns_loss, role_class=dict.fromkeys(roles, 0),
        role_dim=dict.fromkeys(roles, D_W2V), neg_role="neg",
        neg_shape=(B_W2V, N_W2V), neg_population=syn1_key(np.arange(V_W2V)),
        neg_alias=build_alias_table(1.0 / (np.arange(V_W2V) + 10.0)),
        seed=0)
    return srv, w, runner


def w2v_batches(rng, n):
    """bench_w2v's batches: zipf-skewed center (syn0) and context (syn1)
    keys."""
    return [{"center": 2 * skewed_keys(rng, V_W2V, B_W2V),
             "ctx": 2 * skewed_keys(rng, V_W2V, B_W2V) + 1}
            for _ in range(n)]


W2V_APP_ARGS = ["--dim", str(D_W2V), "--negative", str(N_W2V),
                "--batch_size", str(B_W2V), "--scan_steps", str(SCAN_K),
                "--synthetic_vocab", str(V_W2V), "--synthetic_sentences",
                "20000", "--epochs", "2", "--lr", str(W2V_LR),
                "--sys.sync.max_per_sec", "0"]
# tests/test_torch_w2v_mf_apps.py's host-routed configuration
W2V_SMALL_ARGS = ["--synthetic_vocab", "80", "--synthetic_sentences", "120",
                  "--dim", "8", "--window", "3", "--negative", "4",
                  "--epochs", "3", "--batch_size", "256", "--lr", "0.03",
                  "--readahead", "30", "--seed", "11", "--no-device_routes",
                  "--num_shards", "8", "--sys.sync.max_per_sec", "0",
                  "--sys.prefetch", "0"]
MF_APP_ARGS = ["--rows", str(MF_ROWS), "--cols", str(MF_COLS), "--nnz",
               str(MF_NNZ), "--rank", str(MF_RANK), "--batch_size",
               str(B_MF), "--algorithm", "dsgd", "--epochs", "2",
               "--sys.sync.max_per_sec", "0"]
# tests/test_torch_w2v_mf_apps.py's MF configuration (test_mf_app's)
MF_SMALL_ARGS = ["--rows", "48", "--cols", "32", "--nnz", "600", "--rank",
                 "4", "--epochs", "6", "--batch_size", "16", "--lr", "0.1",
                 "--algorithm", "dsgd", "--num_shards", "8",
                 "--sys.sync.max_per_sec", "0", "--sys.prefetch", "0"]


def same_without_pipeline(app, K, argv, res, launches, what, profile):
    """The same app run with the kill switch (--sys.prefetch 0): at S=1
    delegated rounds move nothing, so its epoch losses must be bitwise
    the default run's and its launches and replays the same. Returns its
    epoch seconds and (`profile`) its device seconds and busy share."""
    off, off_launches = run_app(app, K, argv + OFF, profile=profile)
    check(np.array_equal(np.float64(off["epoch_losses"]),
                         np.float64(res["epoch_losses"])),
          f"{what}: epoch losses {off['epoch_losses']} with "
          f"--sys.prefetch 0 differ from {res['epoch_losses']}")
    check(off_launches == launches and off["replayed"] == res["replayed"],
          f"{what}: launches {off_launches}, replayed {off['replayed']} "
          f"with --sys.prefetch 0; {launches}, {res['replayed']} with the "
          "pipeline")
    return {k: off[k] for k in ("epoch_s", "device_s", "busy_share")
            if k in off}


def phase_w2v_app(K):
    """Phase 8: the word2vec app through its entry point on cuda at full
    width on a synthetic zipf corpus, 2 epochs of --scan_steps 8, with
    default knobs (the pipeline on) and with --sys.prefetch 0; then the
    host-routed small configuration on cuda and on cpu."""
    from adapm_tpu_torch.apps import word2vec as w2v
    from adapm_tpu_torch.core.kv import Worker
    from adapm_tpu_torch.core.sync import SyncManager
    from adapm_tpu_torch.io import text as textio
    from adapm_tpu_torch.ops.fused import DeviceRoutedRunner
    corpus = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke_w2v_corpus.txt")
    os.makedirs(os.path.dirname(corpus), exist_ok=True)
    argv = W2V_APP_ARGS + ["--synthetic_path", corpus]
    clock = HostClock([
        (textio, "generate_synthetic_corpus", "corpus generation"),
        (textio, "build_vocab", "build_vocab"),
        (w2v, "_pairs_for", "pairs (intent and train)"),
        (Worker, "intent", "intent"),
        (DeviceRoutedRunner, "__call__", "fused step call"),
        (DeviceRoutedRunner, "run_scan", "run_scan window call"),
        (SyncManager, "run_round", "sync round")])
    with clock:
        res, launches = run_app(w2v, K, argv, profile=True)
    res["host_seconds"] = clock.seconds
    losses = res["epoch_losses"]
    check(np.isfinite(losses).all(), f"phase 8: non-finite loss {losses}")
    check(losses[1] < losses[0], f"phase 8: loss did not fall: {losses}")
    check_launched(launches, "phase 8", W2V_KERNELS)
    steps = sum(res["steps"])
    k6 = launches["sgns_step"] + res["replayed"]["sgns_step"]
    check(k6 == steps, f"phase 8: K6 launched {launches['sgns_step']} "
          f"times and replayed {res['replayed']['sgns_step']} times in "
          f"{steps} steps")
    res["off"] = same_without_pipeline(w2v, K, argv, res, launches,
                                       "phase 8", True)
    with open(corpus) as f:
        res["vocab"] = len({w for line in f for w in line.split()})
    small_g, host_launches = run_app(w2v, K, W2V_SMALL_ARGS + [
        "--synthetic_path", corpus + ".small"])
    check_launched(host_launches, "phase 8 (host routes)", W2V_KERNELS)
    small_c, _ = run_app(w2v, K, W2V_SMALL_ARGS + [
        "--synthetic_path", corpus + ".small"], dev="cpu")
    lg, lc = (np.array(r["epoch_losses"]) for r in (small_g, small_c))
    check(np.allclose(lg, lc, rtol=1e-4, atol=0),
          f"phase 8: host-routed w2v epoch losses cuda {lg} vs cpu {lc} "
          "beyond rtol 1e-4")
    return dict(app=res, launches=launches, host_launches=host_launches,
                small_cuda=lg.tolist(), small_cpu=lc.tolist())


def phase_mf_app(K):
    """Phase 9: the MF app on cuda at rank 128 (a MovieLens-1M-sized
    synthetic matrix, dsgd) on both routing paths, K7 launches adding
    up to the steps, each with default knobs (the pipeline on) and with
    --sys.prefetch 0; then test_mf_app's configuration (8 virtual
    shards) on cuda and on cpu, both routing paths."""
    from adapm_tpu_torch.apps import matrix_factorization as mf
    out = {}
    for routes, extra in (("device", ["--scan_steps", str(SCAN_K)]),
                          ("host", ["--no-device_routes"])):
        res, launches = run_app(mf, K, MF_APP_ARGS + extra,
                                    profile=routes == "device")
        what = f"phase 9 ({routes} routes)"
        losses = res["epoch_losses"]
        check(np.isfinite(losses).all(), f"{what}: non-finite {losses}")
        check(losses[1] < losses[0], f"{what}: loss did not fall: {losses}")
        check_launched(launches, what, MF_KERNELS)
        k7 = launches["mf_step"] + res["replayed"]["mf_step"]
        check(k7 == sum(res["steps"]),
              f"{what}: K7 launched {launches['mf_step']} times and "
              f"replayed {res['replayed']['mf_step']} times in "
              f"{sum(res['steps'])} steps")
        res["off"] = same_without_pipeline(mf, K, MF_APP_ARGS + extra, res,
                                           launches, what,
                                           routes == "device")
        out[routes] = dict(res=res, launches=launches)
    for routes in ("device", "host"):
        argv = MF_SMALL_ARGS + (["--no-device_routes"]
                                if routes == "host" else [])
        rg, _ = run_app(mf, K, argv)
        rc, _ = run_app(mf, K, argv, dev="cpu")
        lg, lc = np.array(rg["epoch_losses"]), np.array(rc["epoch_losses"])
        check(np.allclose(lg, lc, rtol=1e-4, atol=0),
              f"phase 9: MF ({routes} routes) epoch losses cuda {lg} vs cpu "
              f"{lc} beyond rtol 1e-4")
        out[f"small_{routes}"] = dict(cuda=lg.tolist(), cpu=lc.tolist())
    return out


def serve_segment(srv, plane, requests, call, profile=False):
    """One serving segment: a client thread per list in `requests`, each
    issuing its requests one after another through its own session as
    call(session, request). Returns the replies, the wall seconds from
    the release of all clients to the last reply, the clients' own
    latencies, the window of serve.latency_s / serve.batch_size and of
    the serve counters, and (`profile`) the trace's device time by
    kernel (CUDA activity only)."""
    import threading
    names = ("batches_total", "replica_hits_total", "bag_fused_total",
             "bag_hostpool_total", "replica_stale_fallbacks_total")
    before = {k: srv.obs.find(f"serve.{k}") for k in names}
    before = {k: 0 if c is None else c.value for k, c in before.items()}
    h_lat, h_b = (srv.obs.find(f"serve.{k}")
                  for k in ("latency_s", "batch_size"))
    lat0, b0 = h_lat.snap(), h_b.snap()
    replies = [[None] * len(r) for r in requests]
    lats, errors = [], []
    go = threading.Barrier(len(requests) + 1)

    def client(ci):
        try:
            sess = plane.session()
            go.wait(timeout=120)
            for i, req in enumerate(requests[ci]):
                t0 = time.perf_counter()
                replies[ci][i] = call(sess, req)
                lats.append(time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append((ci, repr(e)))
            if not go.broken:
                go.abort()

    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(len(requests))]
    for t in threads:
        t.start()
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as trace
        prof = trace(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    go.wait(timeout=120)
    t0 = time.perf_counter()
    for t in threads:                     # one deadline for all clients
        t.join(timeout=max(0.0, t0 + 300 - time.perf_counter()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    check(not any(t.is_alive() for t in threads), "a serve client hung")
    check(not errors, f"serve clients failed: {errors[:3]}")
    lat1, b1 = h_lat.snap(), h_b.snap()
    win = {"count": lat1["count"] - lat0["count"], "bounds": lat1["bounds"],
           "buckets": [a - b for a, b in zip(lat1["buckets"],
                                             lat0["buckets"])]}
    from adapm_tpu_torch.obs.metrics import hist_percentile
    after = {k: srv.obs.find(f"serve.{k}") for k in names}
    counts = {k: int((0 if c is None else c.value) - before[k])
              for k, c in after.items()}
    n = sum(len(r) for r in requests)
    out = dict(replies=replies, wall_s=wall, requests=n, per_s=n / wall,
               p50_ms=hist_percentile(win, 0.5) * 1e3,
               p99_ms=hist_percentile(win, 0.99) * 1e3,
               client_p50_ms=float(np.percentile(lats, 50)) * 1e3,
               client_p99_ms=float(np.percentile(lats, 99)) * 1e3,
               mean_batch=(b1["sum"] - b0["sum"]) / max(
                   1, b1["count"] - b0["count"]), counts=counts,
               replica_hit_rate=counts["replica_hits_total"] / max(
                   1, counts["batches_total"]))
    if prof is not None:
        by = {}
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                by[ev.key] = by.get(ev.key, 0.0) + \
                    ev.self_device_time_total / 1e3
        dev_ms = sum(by.values())
        out["device_ms"] = dev_ms or None
        out["busy_share"] = dev_ms / (wall * 1e3) if dev_ms else None
        out["kernel_ms"] = {k: sum(v for name, v in by.items() if k in name)
                            for k in ("routed_gather_kernel",
                                      "gather_pool_kernel")}
        top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
        out["top_ms"] = [(_kernel_label(k), v) for k, v in top]
    return out


def phase_serve_flat(at, K, dev):
    """Phase 10 (a): flat lookups on the flagship KGE table (phase 3's
    table and fill): SERVE_CLIENTS threads of SERVE_LOOKUPS lookups of 64
    zipf keys each. Segment 1 with the default knobs on a quiescent
    table, every reply bitwise Worker.pull; segment 2 with 2 dispatchers
    and a 65,536-row replica while a pusher adds to the cold half of the
    table, on fresh keys, then after quiesce() lookups bitwise
    Worker.pull again. Each segment is run again under the profiler for
    its device time."""
    import dataclasses
    import threading
    from adapm_tpu_torch.serve import ServePlane
    t0 = time.perf_counter()
    srv, w = kge_table(at, dev, 5)
    fill_s = time.perf_counter() - t0

    def draw(seed):
        """Each client's lookups: zipf keys from its own generator."""
        gens = [np.random.default_rng(seed + ci)
                for ci in range(SERVE_CLIENTS)]
        return [[skewed_keys(g, E + R, 64) for _ in range(SERVE_LOOKUPS)]
                for g in gens]

    reqs = draw(100)

    def call(sess, keys):
        return sess.lookup(keys, deadline_ms=1000)

    out = dict(fill_s=fill_s)
    K.reset_launches()
    plane = ServePlane(srv)
    seg1 = serve_segment(srv, plane, reqs, call)
    launches = dict(K.LAUNCHES)
    check_launched(launches, "phase 10 (flat)", ("routed_gather",))
    for ci, rs in enumerate(reqs):
        for keys, got in zip(rs, seg1["replies"][ci]):
            check(np.array_equal(got.view(np.uint32),
                                 w.pull_sync(keys).view(np.uint32)),
                  "phase 10: a lookup differs from Worker.pull")
    seg1["launches"] = launches
    prof1 = serve_segment(srv, plane, reqs, call, profile=True)
    plane.close()
    opts2 = dataclasses.replace(srv.opts, serve_dispatchers=2,
                                serve_replica_rows=65_536)
    plane = ServePlane(srv, opts=opts2)
    stop, pushes = threading.Event(), [0]

    def pusher():
        prng = np.random.default_rng(7)
        while not stop.is_set():
            k = prng.integers((E + R) // 2, E + R, 64)
            w.push(k, prng.normal(size=(64, L)).astype(np.float32) * 1e-3)
            pushes[0] += 1
            time.sleep(0.001)

    pt = threading.Thread(target=pusher)
    pt.start()
    K.reset_launches()
    try:
        # fresh keys of the same distribution: replayed lists would find
        # every key they ask for in the replica snapshot
        seg2 = serve_segment(srv, plane, draw(300), call)
        seg2["launches"] = dict(K.LAUNCHES)
        prof2 = serve_segment(srv, plane, draw(400), call, profile=True)
    finally:
        stop.set()
        pt.join(timeout=60)
    check(not pt.is_alive(), "phase 10: the pusher hung")
    srv.quiesce()
    sess = plane.session()
    for rs in reqs:
        for keys in rs[:10]:
            check(np.array_equal(sess.lookup(keys).view(np.uint32),
                                 w.pull_sync(keys).view(np.uint32)),
                  "phase 10: after quiesce a lookup differs from "
                  "Worker.pull")
    # the replica's lock-free path, independent of timing: refresh the
    # snapshot, then look up keys it covers (a background refresh may
    # swap the snapshot between the two, so each round draws anew)
    hits = srv.obs.find("serve.replica_hits_total")
    hits0, kr = hits.value, np.random.default_rng(500)
    for _ in range(10):
        check(plane.replica.refresh_now() > 0,
              "phase 10: the replica refresh snapshotted no rows")
        keys = kr.choice(plane.replica._snap.keys, 64, replace=False)
        check(np.array_equal(sess.lookup(keys).view(np.uint32),
                             w.pull_sync(keys).view(np.uint32)),
              "phase 10: a lookup of replica-covered keys differs from "
              "Worker.pull")
    replica_served = int(hits.value - hits0)
    check(replica_served > 0, "phase 10: no lookup of replica-covered "
          "keys was served from the replica")
    plane.close()
    srv.shutdown()
    for seg, prof in ((seg1, prof1), (seg2, prof2)):
        seg.pop("replies")
        for k in ("device_ms", "busy_share", "kernel_ms", "top_ms"):
            seg[k] = prof.get(k)
        seg["profiled_per_s"] = prof["per_s"]
    out.update(seg1=seg1, seg2=seg2, pushes=pushes[0],
               replica_served=replica_served)
    return out


def phase_serve_bags(at, K, dev):
    """Phase 10 (b): embedding-bag lookups at the DLRM-DCNv2 shape
    (DLRM_CAP rows per table, 7,116,632 keys of [emb 128 | adagrad 128]):
    BAG_CLIENTS threads of BAG_REQUESTS lookup_bags requests of
    DLRM_SAMPLES samples; segments "sum", "mean" and "sum" with
    --sys.serve.bags 0 (flat union + host pool). Every reply bitwise
    pool_bags_host over Worker.pull of its members, the third segment
    bitwise the first, K8 launched once per fused batch (one length
    class, one pooling per segment) and not at all in the third."""
    from adapm_tpu_torch.serve import ServePlane
    from adapm_tpu_torch.serve.bags import pool_bags_host
    caps, offs = dlrm_table()
    nkeys = int(caps.sum())
    t0 = time.perf_counter()
    srv = at.setup(nkeys, L_DLRM, opts=at.SystemOptions(
        cache_slots_per_shard=1, sync_max_per_sec=0), device=dev)
    w = srv.make_worker(0)
    fill = np.random.default_rng(4)
    for lo in range(0, nkeys, 1 << 20):
        hi = min(lo + (1 << 20), nkeys)
        # uniform draws: a third of normal draws' host time over the
        # table's 1.8e9 values; the checks compare the server with itself
        vals = fill.random((hi - lo, L_DLRM), dtype=np.float32)
        vals *= 0.01
        w.set(np.arange(lo, hi), vals)
    srv.block()
    fill_s = time.perf_counter() - t0
    reqs = []
    for ci in range(BAG_CLIENTS):
        rng = np.random.default_rng(200 + ci)
        reqs.append([dlrm_request(rng, caps, offs)
                     for _ in range(BAG_REQUESTS)])
    plane = ServePlane(srv)
    segs = {}
    K.reset_launches()
    for name, pooling, fused in (("sum", "sum", True),
                                 ("mean", "mean", True),
                                 ("sum, --sys.serve.bags 0", "sum",
                                  False)):
        plane.opts.serve_bags = fused
        before = K.LAUNCHES["gather_pool"]
        seg = serve_segment(
            srv, plane, reqs, lambda sess, r, p=pooling: sess.lookup_bags(
                r[0], r[1], pooling=p, deadline_ms=10_000))
        seg["k8_launches"] = K.LAUNCHES["gather_pool"] - before
        want = seg["counts"]["bag_fused_total"] if fused else 0
        check(seg["k8_launches"] == want,
              f"phase 10 ({name}): K8 launched {seg['k8_launches']} "
              f"times for {want} fused batches")
        segs[name] = seg
    launches = dict(K.LAUNCHES)
    check_launched(launches, "phase 10 (bags)", ("gather_pool",))
    plane.opts.serve_bags = True
    prof = serve_segment(
        srv, plane, reqs, lambda sess, r: sess.lookup_bags(
            r[0], r[1], pooling="sum", deadline_ms=10_000), profile=True)
    plane.close()
    for ci, rs in enumerate(reqs):
        # one pull of all the client's members: nothing writes after the
        # segments, so each request's rows are the bits it would pull alone
        rows = w.pull_sync(np.concatenate([ks for tables, _ in rs
                                           for ks in tables]))
        lo = 0
        for i, (tables, bags) in enumerate(rs):
            for t, (ks, bg) in enumerate(zip(tables, bags)):
                mine = rows[lo:lo + len(ks)]
                lo += len(ks)
                seg_ix = np.repeat(np.arange(len(bg) - 1),
                                   np.diff(bg)).astype(np.int32)
                for name, pooling in (("sum", "sum"), ("mean", "mean"),
                                      ("sum, --sys.serve.bags 0", "sum")):
                    ref = pool_bags_host(mine, seg_ix, len(bg) - 1, pooling)
                    got = segs[name]["replies"][ci][i][t]
                    check(np.array_equal(got.view(np.uint32),
                                         ref.view(np.uint32)),
                          f"phase 10 ({name}): request {ci}/{i} table {t} "
                          "differs from pool_bags_host over Worker.pull")
    srv.shutdown()
    for seg in segs.values():
        seg.pop("replies")
        seg["samples_per_s"] = seg["per_s"] * DLRM_SAMPLES
        seg["bags_per_s"] = seg["samples_per_s"] * len(DLRM_HOTS)
    prof.pop("replies")
    k8_ms = prof["kernel_ms"]["gather_pool_kernel"]
    return dict(fill_s=fill_s, keys=nkeys, segments=segs,
                launches=launches, profile=dict(
                    samples_per_s=prof["per_s"] * DLRM_SAMPLES,
                    device_ms=prof["device_ms"],
                    busy_share=prof["busy_share"], k8_ms=k8_ms,
                    k8_share=k8_ms / prof["device_ms"]
                    if prof["device_ms"] else None, top_ms=prof["top_ms"]))


def report_serve(flat, bags, smi):
    """Phase 10's lines, each with the card's nvidia-smi line."""
    for name, seg in (("segment 1 (default knobs)", flat["seg1"]),
                      ("segment 2 (2 dispatchers, 65,536-row replica, "
                       f"{flat['pushes']} pushes)", flat["seg2"])):
        busy = "not measured" if seg["busy_share"] is None else (
            f"{seg['busy_share']:.4f} ({seg['device_ms']:.1f} ms of device "
            f"time, K1 {seg['kernel_ms']['routed_gather_kernel']:.1f} ms, "
            f"{seg['profiled_per_s']:.0f} lookups/s under the profiler; "
            "top: " + "; ".join(f"{k} {v:.1f}" for k, v in seg["top_ms"])
            + ")")
        print(f"phase 10: flat {name}: {seg['requests']} lookups of 64 keys "
              f"by {SERVE_CLIENTS} clients in {seg['wall_s']:.3f} s, "
              f"{seg['per_s']:.0f} lookups/s, serve.latency_s p50 "
              f"{seg['p50_ms']:.3f} p99 {seg['p99_ms']:.3f} ms (clients' "
              f"own p50 {seg['client_p50_ms']:.3f} p99 "
              f"{seg['client_p99_ms']:.3f} ms), mean batch "
              f"{seg['mean_batch']:.2f} requests, replica hit rate "
              f"{seg['replica_hit_rate']:.4f} (stale fallbacks "
              f"{seg['counts']['replica_stale_fallbacks_total']}), K1 "
              f"launches {seg['launches']['routed_gather']}, device busy "
              f"{busy} | {smi}", flush=True)
    print(f"phase 10: flat, after quiesce: {SERVE_CLIENTS * 10} lookups "
          "bitwise Worker.pull;"
          f" after a forced refresh {flat['replica_served']} of 10 lookups "
          "of snapshot-covered keys served from the replica, all 10 bitwise "
          "Worker.pull", flush=True)
    for name, seg in bags["segments"].items():
        print(f"phase 10: bags {name}: {seg['requests']} requests of "
              f"{DLRM_SAMPLES} samples x {len(DLRM_HOTS)} tables by "
              f"{BAG_CLIENTS} clients in {seg['wall_s']:.3f} s, "
              f"{seg['samples_per_s']:.0f} samples/s, "
              f"{seg['bags_per_s']:.0f} bags/s, serve.latency_s p50 "
              f"{seg['p50_ms']:.3f} p99 {seg['p99_ms']:.3f} ms (clients' "
              f"own p50 {seg['client_p50_ms']:.3f} p99 "
              f"{seg['client_p99_ms']:.3f} ms), mean batch "
              f"{seg['mean_batch']:.2f}, fused batches "
              f"{seg['counts']['bag_fused_total']}, host-pooled "
              f"{seg['counts']['bag_hostpool_total']}, K8 launches "
              f"{seg['k8_launches']} | {smi}", flush=True)
    p = bags["profile"]
    busy = "not measured" if p["busy_share"] is None else (
        f"busy {p['busy_share']:.4f}, device {p['device_ms']:.1f} ms, K8 "
        f"{p['k8_ms']:.1f} ms ({p['k8_share']:.3f} of the device time); "
        "top: " + "; ".join(f"{k} {v:.1f}" for k, v in p["top_ms"]))
    print(f"phase 10: bags sum under the profiler: "
          f"{p['samples_per_s']:.0f} samples/s, {busy}; table of "
          f"{bags['keys']} keys filled in {bags['fill_s']:.1f} s; every "
          "reply bitwise pool_bags_host over Worker.pull, bags-0 replies "
          f"bitwise the sum segment's | {smi}", flush=True)


WIRE_BYTES = {"fp32": lambda n: 4 * n, "fp16": lambda n: 2 * n,
              "int8": lambda n: n + 4}   # per row of n f32 (int8: + scale)


def grid_rows(rng, n, width, step=2.0 ** -7):
    """Rows exactly on an int8 grid (integers q*step, |q| <= 127, one
    element of each row at +-127, step a power of two): every cold
    format stores them exactly, so no residual parks and a row reads the
    same bits hot or cold. Drawn as int8 (a quarter of an int64 draw's
    host time: phase 13 (c) fills 7,116,632 rows this way)."""
    q = rng.integers(-126, 127, size=(n, width), dtype=np.int8).astype(
        np.float32)
    q[:, 0] = np.where(rng.random(n) < 0.5, -127.0, 127.0)
    q *= np.float32(step)
    return q


def wire_of(mode, rows, dev):
    """(wire rows, scale or None, dequantized rows) on `dev` for f32
    `rows` in cold format `mode` (the port's tier/quant.py)."""
    from adapm_tpu_torch.tier.quant import dequantize_rows, quantize_rows
    q, s = quantize_rows(mode, rows)
    deq = dequantize_rows(mode, q, s)
    t = lambda a: None if a is None else torch.as_tensor(a, device=dev)  # noqa
    return t(q), t(s), t(deq)


def bitwise(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def phase_k9(K, dev, rng):
    """Phase 2, K9: one tiered KGE step's pull (ROWS entries of L f32, a
    third of them cold, the rest hot rows of a 65,536-row pool) in each
    wire format: bitwise its plain version and over two runs, timed
    beside index_select + torch.where over pre-dequantized cold rows."""
    H = TIER_HOT
    main = torch.randn((1, H, L), device=dev)
    main[0, :4] = -0.0
    cache = torch.randn((1, 8, L), device=dev)
    delta = torch.randn((1, 8, L), device=dev)
    cold = rng.random(ROWS) < 1 / 3
    rows = skewed_keys(rng, H, ROWS).astype(np.int32)
    rows[cold] = 2**31 - 2
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    o_sh = t(np.zeros(ROWS, np.int32))
    o_row, use_cold = t(rows), t(cold)
    c_sl = t(np.full(ROWS, 2**31 - 2, np.int32))
    use_c = t(np.zeros(ROWS, bool))
    vals = np.zeros((ROWS, L), np.float32)
    cold_rows = rng.standard_normal((int(cold.sum()), L), np.float32)
    cold_rows[:, ::7] = -0.0
    vals[cold] = cold_rows
    hot_idx = t(np.where(cold, 0, rows).astype(np.int64))
    mflat = main.view(-1, L)
    n_cold, n_hot = int(cold.sum()), len(np.unique(rows[~cold]))
    out = {}
    for mode in ("fp32", "fp16", "int8"):
        q, s, deq = wire_of(mode, vals, dev)
        args = (main, cache, delta, o_sh, o_row, o_sh, c_sl, use_c, mode, q,
                s, use_cold)
        got = [K.gather_cold(*args) for _ in range(2)]
        ref = K.gather_cold_plain(*args)
        check(bitwise(got[0], got[1]) and bitwise(got[0], ref),
              f"K9 ({mode}) differs from its plain version or between "
              "two runs")
        nbytes = (n_hot * L * 4 + WIRE_BYTES[mode](L) * n_cold
                  + ROWS * (4 + 4 + 1 + 1) + ROWS * L * 4)
        out[mode] = timed(
            cuda_ms(lambda: K.gather_cold(*args)),
            cuda_ms(lambda: K.gather_cold_plain(*args)),
            cuda_ms(lambda: torch.where(use_cold[:, None], deq,
                                        mflat.index_select(0, hot_idx))),
            max_abs_err=float((got[0] - ref).abs().max()),
            bound=bound(nbytes, n_cold * L if mode == "int8" else 0),
            cold_entries=n_cold, entries=ROWS)
    return dict(out["int8"], modes=out)


def dlrm_hot_rows(caps, offs):
    """The hot set of phase 2's K10 table: in each table the same share
    of its lowest keys (its most requested under the zipf skew), as many
    as TIER_BAG_HOT rows in all. Returns key -> hot row (-1 when cold)."""
    nkeys = int(caps.sum())
    share = TIER_BAG_HOT / nkeys
    row = np.full(nkeys, -1, np.int64)
    nxt = 0
    for cap, off in zip(caps, offs):
        k = min(int(np.ceil(cap * share)), TIER_BAG_HOT - nxt)
        row[off:off + k] = np.arange(nxt, nxt + k)
        nxt += k
    return row


def phase_k10(K, dev, rng):
    """Phase 2, K10: phase 10's two bag batches (BAG_CLIENTS and
    K8_REQUESTS requests) over the DLRM table tiered: TIER_BAG_HOT hot
    rows, the rest int8 cold rows staged per member, sum and mean,
    bitwise its plain version and over two runs; timed in the trace
    beside embedding_bag over the hot pool joined with the pre-dequantized
    cold rows."""
    from adapm_tpu_torch.core.store import OOB, bucket_size, pad_bucket
    caps, offs = dlrm_table()
    hot_row = dlrm_hot_rows(caps, offs)
    H = TIER_BAG_HOT
    main = torch.randn((1, H, L_DLRM), device=dev) * 0.01
    cache = torch.zeros((1, 8, L_DLRM), device=dev)
    delta = torch.zeros((1, 8, L_DLRM), device=dev)
    recs = {}
    for nreq in (BAG_CLIENTS, K8_REQUESTS):
        keys, seg, nbags = k8_batch(rng, nreq, caps, offs)
        n = len(keys)
        nb = bucket_size(nbags)
        hr = hot_row[keys]
        cold = hr < 0
        z = np.zeros(n, np.int32)
        o_row = np.where(cold, OOB, hr).astype(np.int32)
        a = [torch.as_tensor(x, device=dev) for x in pad_bucket(
            n, (z, 0), (o_row, OOB), (z, 0), (np.full(n, OOB, np.int32), OOB),
            (z > 0, False), (cold, False), (seg, OOB))]
        o_sh, o_r, c_sh, c_sl, use_c, use_cold, seg_t = a
        b = o_sh.numel()
        vals = np.zeros((b, L_DLRM), np.float32)
        vals[:n][cold] = grid_rows(rng, int(cold.sum()), L_DLRM, 2.0 ** -12)
        q, s, deq = wire_of("int8", vals, dev)
        args = (main, cache, delta, o_sh, o_r, c_sh, c_sl, use_c, "int8", q,
                s, use_cold, seg_t)
        errs = {}
        for pooling in ("sum", "mean"):
            outs = [K.gather_pool_cold(*args, torch.zeros(
                (nb, L_DLRM), device=dev), pooling, sorted_seg=True)
                for _ in range(2)]
            ref = K.gather_pool_cold_plain(
                *args, torch.zeros((nb, L_DLRM), device=dev), pooling)
            check(bitwise(outs[0], outs[1]) and bitwise(outs[0], ref),
                  f"K10 ({nreq} requests, {pooling}) differs from its "
                  "plain version or between two runs")
            errs[pooling] = float((outs[0] - ref).abs().max())
        out = torch.zeros((nb, L_DLRM), device=dev)
        trace, _ = kernel_ms(lambda: K.gather_pool_cold(
            *args, out, "sum", sorted_seg=True), "gather_pool_kernel")
        joined = torch.cat([main.view(-1, L_DLRM), deq])
        idx = torch.as_tensor(np.where(cold, H + np.arange(n), hr),
                              device=dev)
        starts = torch.as_tensor(np.searchsorted(seg, np.arange(nbags)),
                                 device=dev)
        library = cuda_ms(lambda: torch.nn.functional.embedding_bag(
            idx, joined, starts, mode="sum"))
        n_cold = int(cold.sum())
        nbytes = (len(np.unique(hr[~cold])) * L_DLRM * 4
                  + n_cold * (L_DLRM + 4) + n * 18 + 2 * nbags * L_DLRM * 4)
        recs[nreq] = timed(
            trace, cuda_ms(lambda: K.gather_pool_cold_plain(*args, out, "sum"),
                           reps=5, warmup=1), library,
            max_abs_err=max(errs.values()), bound=bound(nbytes, n * L_DLRM),
            requests=nreq, members=n, bags=nbags, cold_members=n_cold,
            cold_share=n_cold / n)
        del joined
    return dict(recs[BAG_CLIENTS], full_batch=recs[K8_REQUESTS])


def k11_batches(rng):
    """Phase 2's two K11 batches of TIER_PROMOTED entries into a
    TIER_HOT-row pool (S=1), as (name, sh, row): promotion's own shape
    (distinct rows), and the contract's hard cases: a quarter of the
    entries repeat an earlier entry's target (a repeat of a repeat names
    it a third time or more), entries with sh >= S or a negative row,
    and a tail of OOB bucket padding."""
    from adapm_tpu_torch.core.store import OOB
    n = TIER_PROMOTED
    distinct = rng.permutation(TIER_HOT)[:n].astype(np.int32)
    row = distinct.copy()
    rep = np.sort(rng.choice(np.arange(1, n), n // 4, replace=False))
    for i in rep:
        row[i] = row[rng.integers(0, i)]
    sh = np.zeros(n, np.int32)
    odd = rng.choice(n, 128, replace=False)
    sh[odd[:64]] = 1
    row[odd[64:]] = -3
    row[-n // 16:] = OOB
    return [("distinct", np.zeros(n, np.int32), distinct), ("duplicates", sh,
                                                            row)]


def one_call_kernels(fn, reps=20, us=False):
    """The device records of one call of fn(), {name: records a call},
    from a profiler trace of `reps` calls (after a warm-up call); with
    `us`, {name: [records a call, device us a call]}. A trace that lost
    a record (kernel_ms) leaves a count that is not whole a call; it is
    taken again, up to four times, and TRACE_RETAKES counts the retakes
    under "one call"."""
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile
    fn()
    for attempt in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        names = Counter(e.name for e in evs)
        if all(c % reps == 0 for c in names.values()):
            break
        TRACE_RETAKES["one call"] = TRACE_RETAKES.get("one call", 0) + 1
    if not us:
        return {k: c / reps for k, c in names.items()}
    dev_us = Counter()
    for e in evs:
        dev_us[e.name] += e.self_device_time_total / reps
    return {k: [c / reps, round(dev_us[k], 2)] for k, c in names.items()}


def device_ms(fn, traces=3):
    """The device ms per call of everything fn() runs, from `traces`
    profiler traces of 20 calls each: (median, min, max) of the traces'
    per-call means."""
    t = [kernel_ms(fn, None)[1] for _ in range(traces)]
    return float(np.median(t)), float(min(t)), float(max(t))


def phase_k11(K, dev, rng):
    """Phase 2, K11: TIER_PROMOTED rows of L f32 into a TIER_HOT-row hot
    pool in each wire format, for each of k11_batches' batches: bitwise
    its plain version and over two runs, its claim scratch all -1 after
    every call; timed by the device time of all a call launches (the
    profiler trace) and between CUDA events, beside index_copy_ of the
    winners' pre-dequantized rows."""
    pool = torch.randn((1, TIER_HOT, L), device=dev)
    pool[0, :4] = -0.0
    vals = rng.standard_normal((TIER_PROMOTED, L), np.float32)
    vals[:64, ::3] = -0.0
    claims = getattr(K, "_claims", None)   # None in a tree before them
    batches = {}
    call_kernels = None
    for name, sh_np, row_np in k11_batches(rng):
        sh, row = (torch.as_tensor(a, device=dev) for a in (sh_np, row_np))
        tgt, keep = K.set_winners(pool, sh, row)   # the winners, in order
        winners = int(tgt.numel())
        out = {}
        for mode in ("fp32", "fp16", "int8"):
            q, s, deq = wire_of(mode, vals, dev)
            got = []
            for _ in range(2):
                got.append(K.write_main_rows(pool.clone(), sh, row, mode, q,
                                             s))
                check(claims is None or all(bool((c == -1).all())
                                            for c in claims.values()),
                      f"K11 ({name}, {mode}) left its claim scratch set")
            ref = K.write_main_rows_plain(pool.clone(), sh, row, mode, q, s)
            check(bitwise(got[0], got[1]) and bitwise(got[0], ref),
                  f"K11 ({name}, {mode}) differs from its plain version or "
                  "between two runs")
            scratch = pool.clone()
            flat = scratch.view(-1, L)
            dw = deq[keep]

            def k11(scratch=scratch, sh=sh, row=row, mode=mode, q=q, s=s):
                K.write_main_rows(scratch, sh, row, mode, q, s)

            def library(flat=flat, tgt=tgt, dw=dw):
                flat.index_copy_(0, tgt, dw)

            if claims is not None and call_kernels is None:
                call_kernels = one_call_kernels(k11)
                check(sorted("claim_kernel" in k for k in call_kernels)
                      == [False, True] and all(
                          ("claim_kernel" in k or "write_rows_kernel" in k)
                          and n == 1 for k, n in call_kernels.items()),
                      f"K11: one call ran {call_kernels}, not its claim "
                      "and write kernels alone")
            out[mode] = timed(
                device_ms(k11),
                cuda_ms(lambda: K.write_main_rows_plain(scratch, sh, row,
                                                        mode, q, s)),
                device_ms(library),
                max_abs_err=float((got[0] - ref).abs().max()),
                event_ms=cuda_ms(k11), library_event_ms=cuda_ms(library),
                write_ms=kernel_ms(k11, "write_rows_kernel")[0],
                bound=bound(WIRE_BYTES[mode](L) * winners
                            + winners * L * 4 + len(row_np) * 8,
                            winners * L if mode == "int8" else 0),
                rows=len(row_np), winners=winners)
            del got, ref, scratch, flat, dw
        batches[name] = dict(out["int8"], modes=out)
    return dict(batches["distinct"], duplicates=batches["duplicates"],
                call_kernels=call_kernels)


def phase_k12(K, dev, rng):
    """Phase 2, K12: 65,536 replica rows of L f32, half of them below the
    threshold, fp16 and int8: its four outputs bitwise its plain version
    and over two runs. No single library call computes this."""
    n = TIER_SYNC_ROWS
    delta = torch.as_tensor(rng.standard_normal((1, n, L), np.float32),
                            device=dev)
    delta[0, n // 2:] *= 1e-3
    delta[0, :4, ::5] = -0.0
    r_sh = torch.zeros(n, dtype=torch.int32, device=dev)
    r_cs = torch.as_tensor(rng.permutation(n).astype(np.int32), device=dev)
    thr = 0.5
    out = {}
    for mode in ("fp16", "int8"):
        got = [K.sync_compress(delta, r_sh, r_cs, mode, thr)
               for _ in range(2)]
        ref = K.sync_compress_plain(delta, r_sh, r_cs, mode, thr)
        for i, name in enumerate(("shipped", "new delta", "ship",
                                  "residual norm")):
            a, b, c = got[0][i], got[1][i], ref[i]
            same = torch.equal(a, b) and torch.equal(a, c) if i == 2 else \
                bitwise(a.reshape(-1), b.reshape(-1)) and \
                bitwise(a.reshape(-1), c.reshape(-1))
            check(same, f"K12 ({mode}) {name} differs from its plain "
                  "version or between two runs")
        shipped = int(got[0][2].sum())
        out[mode] = timed(
            cuda_ms(lambda: K.sync_compress(delta, r_sh, r_cs, mode, thr)),
            cuda_ms(lambda: K.sync_compress_plain(delta, r_sh, r_cs, mode,
                                                  thr)), None,
            max_abs_err=float((got[0][1] - ref[1]).abs().max()),
            bound=bound(n * L * 4 * 3 + n * 9, n * L * 4),
            rows=n, shipped_rows=shipped)
    return dict(out["int8"], modes=out)


def claims_clear(K):
    """K11's and K14's claim scratch all -1 (as every call leaves it)."""
    return all(bool((c == -1).all()) for c in K._claims.values())


def phase_k14(K, dev, rng):
    """Phase 2, K14: K11's shape (TIER_PROMOTED entries of L f32 into a
    TIER_HOT-row pool, S=1) for each of k11_batches' batches (distinct
    rows; a quarter repeating an earlier target, drops and OOB padding):
    the set form, the install form on a cache/delta pair (from source
    rows, and read from a main pool of phase 3's rows as replica_create
    reads it) and the zero form, each bitwise its plain version and over
    two runs, the claim scratch all -1 after every call. Timed by the
    device time of all a call launches (the trace) and between CUDA
    events, beside index_copy_ of the winners (the set form) and the
    plain version, which is the parent's path (set_winners: a stable
    sort, a mask, an indexed write)."""
    pool = torch.randn((1, TIER_HOT, L), device=dev)
    pool[0, :4] = -0.0
    cache = torch.randn((1, TIER_HOT, L), device=dev)
    delta = torch.randn((1, TIER_HOT, L), device=dev)
    vals = torch.as_tensor(rng.standard_normal((TIER_PROMOTED, L),
                                               np.float32), device=dev)
    vals[:64, ::3] = -0.0
    src = torch.randn((1, 2 * TIER_HOT, L), device=dev)
    src[0, :8] = -0.0
    o_sl = torch.as_tensor(rng.integers(0, 2 * TIER_HOT, TIER_PROMOTED)
                           .astype(np.int32), device=dev)
    o_sl[::97] = 2**31 - 2
    o_sh = torch.zeros_like(o_sl)
    batches, call_kernels = {}, None
    for name, sh_np, row_np in k11_batches(rng):
        sh, row = (torch.as_tensor(a, device=dev) for a in (sh_np, row_np))
        tgt, keep = K.set_winners(pool, sh, row)
        winners = int(tgt.numel())
        forms = {
            "set": ((pool,), lambda p: K.drop_set(*p, sh, row, vals),
                    lambda p: K.drop_set_plain(*p, sh, row, vals),
                    winners * L * 8),
            "install": ((cache, delta), lambda p: K.drop_set_install(
                *p, sh, row, rows=vals), lambda p: K.drop_set_install_plain(
                    *p, sh, row, rows=vals), winners * L * 12),
            "install_src": ((cache, delta), lambda p: K.drop_set_install(
                *p, sh, row, src=(src, o_sh, o_sl)),
                lambda p: K.drop_set_install_plain(
                    *p, sh, row, src=(src, o_sh, o_sl)),
                winners * L * 12 + len(row_np) * 8),
            "zero": ((pool,), lambda p: K.drop_set_zero(*p, sh, row),
                     lambda p: K.drop_set_zero_plain(*p, sh, row),
                     winners * L * 4),
        }
        out = {}
        for form, (pools, kern, plain, nbytes) in forms.items():
            # every form bitwise on both batches; the duplicates batch
            # times the set form alone (K11's batch, K11's yardstick)
            timed_form = name == "distinct" or form == "set"
            got = []
            for _ in range(2):
                p = [t.clone() for t in pools]
                kern(p)
                got.append(p)
                check(claims_clear(K), f"K14 ({name}, {form}) left its "
                      "claim scratch set")
            ref = [t.clone() for t in pools]
            plain(ref)
            check(all(bitwise(a, b) and bitwise(a, c)
                      for a, b, c in zip(got[0], got[1], ref)),
                  f"K14 ({name}, {form}) differs from its plain version or "
                  "between two runs")
            if not timed_form:
                out[form] = dict(max_abs_err=max(
                    float((a - b).abs().max()) for a, b in zip(got[0], ref)),
                    rows=len(row_np), winners=winners)
                del got, ref
                continue
            scratch = [t.clone() for t in pools]
            library = None
            if form == "set":
                flat, dw = scratch[0].view(-1, L), vals[keep]

                def library(flat=flat, tgt=tgt, dw=dw):
                    flat.index_copy_(0, tgt, dw)

                if call_kernels is None:
                    call_kernels = one_call_kernels(lambda: kern(scratch))
                    check(sorted("claim_kernel" in k for k in call_kernels)
                          == [False, True] and all(n == 1 for n in
                                                   call_kernels.values()),
                          f"K14: one call ran {call_kernels}, not its "
                          "claim and write kernels alone")
            out[form] = timed(
                device_ms(lambda: kern(scratch)),
                cuda_ms(lambda: plain(scratch)),
                None if library is None else device_ms(library),
                max_abs_err=max(float((a - b).abs().max())
                                for a, b in zip(got[0], ref)),
                event_ms=cuda_ms(lambda: kern(scratch)),
                library_event_ms=None if library is None
                else cuda_ms(library),
                bound=bound(nbytes + len(row_np) * 8, 0),
                rows=len(row_np), winners=winners)
            del got, ref, scratch
        batches[name] = dict(out["set"], forms=out)
    return dict(batches["distinct"], duplicates=batches["duplicates"],
                call_kernels=call_kernels)


def sync_setup(rng, dev, S, n, C):
    """A planner round's pools at phase 12's layout: keys of L f32, key k
    owned by shard k % S at slot k // S and replicated on every other
    shard, n replicas in all (S=2: one a key, owners distinct in a round;
    S=4: three, each owner folded three times), the replica slots a
    permutation of each shard's C cache slots; half the keys' deltas
    below the threshold 0.5, in a shuffled batch order."""
    keys = n // (S - 1)
    main = torch.randn((S, -(-keys // S), L), device=dev)
    main[:, :4] = -0.0
    cache = torch.randn((S, C, L), device=dev)
    delta = torch.randn((S, C, L), device=dev)
    delta[:, 1::2] *= 1e-3
    delta[0, :4, ::5] = -0.0
    k = np.tile(np.arange(keys), S - 1)
    j = np.repeat(np.arange(1, S), keys)
    o_sh, o_sl, r_sh = k % S, k // S, (k + j) % S
    r_cs = np.empty(len(k), np.int64)
    for sh in range(S):
        at = np.flatnonzero(r_sh == sh)
        r_cs[at] = rng.permutation(C)[:len(at)]
    order = rng.permutation(len(k))
    coords = [torch.as_tensor(a[order].astype(np.int32), device=dev)
              for a in (r_sh, r_cs, o_sh, o_sl)]
    return [main, cache, delta], coords


def parent_sync(K, main, cache, delta, r_sh, r_cs, o_sh, o_sl, thr):
    """The parent's planner round (device/torchport.py before K15): K1
    extracts the deltas, torch ops hold the rows below the threshold, K3
    merges, K1 re-gathers the fresh owner rows, and two set_winners sets
    install them and zero the deltas."""
    dvals = K.routed_gather(delta, None, None, r_sh, r_cs)
    if thr > 0.0:
        ship = dvals.abs().amax(dim=1) >= torch.tensor(thr,
                                                       device=main.device)
        oob = torch.full_like(r_cs, 2**31 - 2)
        r_cs = torch.where(ship, r_cs, oob)
        o_sl = torch.where(ship, o_sl, oob)
    K.ordered_scatter_add(main, o_sh, o_sl, dvals)
    fresh = K.routed_gather(main, None, None, o_sh, o_sl)
    K.drop_set_plain(cache, r_sh, r_cs, fresh)
    K.drop_set_plain(delta, r_sh, r_cs, torch.zeros_like(fresh))


def fresh_ms(run, restore, reps=20, traces=3, events=True):
    """Device ms a call (every record of the calls, from a profiler
    trace) and ms a call between CUDA events, as (median, min, max), of
    `reps` calls run(i) whose inputs restore() makes fresh before each
    batch of calls, outside the timing: a planner round zeroes the deltas
    it reads, so the next round on the same rows would ship nothing."""
    from torch.profiler import ProfilerActivity, profile
    run(0)
    dev_t, ev_t = [], []
    for _ in range(traces):
        restore()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                run(i)
            torch.cuda.synchronize()
        dev_t.append(sum(e.self_device_time_total for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
                     / 1e3 / reps)
        if not events:
            continue
        restore()
        evs = [(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(evs):
            a.record()
            run(i)
            b.record()
        torch.cuda.synchronize()
        ev_t += [a.elapsed_time(b) for a, b in evs]
    stat = lambda t: (float(np.median(t)), float(min(t)),  # noqa: E731
                      float(max(t)))
    return stat(dev_t), stat(ev_t) if ev_t else None


def phase_k15(K, dev, rng):
    """Phase 2, K15: TIER_SYNC_ROWS replica rows of L f32 at S=2 (phase
    12's layout at K12's shape), at threshold 0 and with half the rows
    held: bitwise its plain version, the parent's composition and over
    two runs, the claim scratch all -1; timed by the device time of all a
    round launches (the trace) and between CUDA events, each round on
    fresh deltas, beside the parent's K1 + K3 + K1 + two-set composition
    (no single library call computes it). Then bitwise only at S=4,
    where every owner folds three replicas in a round."""
    n = TIER_SYNC_ROWS
    reps = 20
    out = {}
    pools, co = sync_setup(rng, dev, 2, n, n // 2 + 4096)
    deltas = [pools[2].clone() for _ in range(reps)]

    def restore():
        for d in deltas:
            d.copy_(pools[2])

    for thr in (0.0, 0.5):
        got = []
        for _ in range(2):
            p = [t.clone() for t in pools]
            K.sync_round(*p, *co, threshold=thr)
            got.append(p)
        check(claims_clear(K), f"K15 (threshold {thr}) left K14's claim "
              "scratch set")
        ref = [t.clone() for t in pools]
        K.sync_round_plain(*ref, *co, threshold=thr)
        par = [t.clone() for t in pools]
        parent_sync(K, *par, *co, thr)
        check(all(bitwise(a, b) and bitwise(a, c) and bitwise(a, d)
                  for a, b, c, d in zip(got[0], got[1], ref, par)),
              f"K15 (threshold {thr}) differs from its plain version, the "
              "parent's composition or between two runs")
        dv = K._fill_gather_plain(pools[2], co[0], co[1])
        shipped = int((dv.abs().amax(dim=1) >= thr).sum())
        del dv, got, ref, par
        main, cache = pools[0].clone(), pools[1].clone()

        def kern(i, thr=thr):
            K.sync_round(main, cache, deltas[i], *co, threshold=thr)

        def parent(i, thr=thr):
            parent_sync(K, main, cache, deltas[i], *co, thr)

        def plain(i, thr=thr):
            K.sync_round_plain(main, cache, deltas[i], *co, threshold=thr)

        # five calls (a warm-up and four traced), each on fresh deltas
        # (a retaken trace may reach a round whose deltas are zero)
        restore()
        fresh = itertools.count()
        calls = one_call_kernels(lambda: kern(next(fresh) % reps), reps=4,
                                 us=True)
        restore()
        fresh = itertools.count()
        parent_calls = one_call_kernels(lambda: parent(next(fresh) % reps),
                                        reps=4)
        ms, event_ms = fresh_ms(kern, restore)
        parent_ms, parent_event_ms = fresh_ms(parent, restore)
        plain_ms = fresh_ms(plain, restore, reps=3, traces=1,
                            events=False)[0]
        # each input byte read once, each output byte written once: the
        # delta rows (all, for the threshold's max-abs), the shipped
        # owners' rows read and written, the shipped replicas' cache and
        # delta rows written; four int32 coordinates an entry
        nbytes = n * L * 4 + shipped * L * 4 * 4 + n * 16
        out[thr] = timed(
            ms, plain_ms, None, max_abs_err=0.0, event_ms=event_ms,
            parent_ms=parent_ms, parent_event_ms=parent_event_ms,
            bound=bound(nbytes, shipped * L), rows=n, shipped=shipped,
            launches_a_round=sum(c for c, _ in calls.values()),
            parent_launches_a_round=sum(parent_calls.values()),
            call_kernels=calls)
        del main, cache
    del pools, deltas
    torch.cuda.empty_cache()
    pools, co = sync_setup(rng, dev, 4, n, n // 4 + 4096)
    for thr in (0.0, 0.5):
        got = []
        for _ in range(2):
            p = [t.clone() for t in pools]
            K.sync_round(*p, *co, threshold=thr)
            got.append(p)
        ref = [t.clone() for t in pools]
        K.sync_round_plain(*ref, *co, threshold=thr)
        check(all(bitwise(a, b) and bitwise(a, c)
                  for a, b, c in zip(got[0], got[1], ref)),
              f"K15 at S=4 (threshold {thr}, owners folded three times a "
              "round) differs from its plain version or between two runs")
        del got, ref
    del pools
    torch.cuda.empty_cache()
    return dict(out[0.0], held=out[0.5], s4_bitwise=True,
                heavy=k15_heavy(K, dev, rng),
                ptxas=ptxas_summary("sync_round"))


def k15_heavy(K, dev, rng):
    """K15's heavy round: 4,096 replicas at S=2 (phase 12's layout) and
    K15_HOT more naming owner row (0, 1), each from a replica row of its
    own, in a shuffled batch order, at threshold 0 and half held: bitwise
    its plain version and over two runs, the claim scratch all -1; the
    device records of a round with their us (the trace)."""
    n = 4096
    pools, co = sync_setup(rng, dev, 2, n, n // 2 + 64)
    C = pools[1].shape[1]
    extra = [torch.randn((2, K15_HOT, L), device=dev) for _ in range(2)]
    extra[1][:, ::2] *= 1e-3                  # half of them held at 0.5
    pools[1:] = [torch.cat([p, x], dim=1).contiguous()
                 for p, x in zip(pools[1:], extra)]
    i32 = dict(dtype=torch.int32, device=dev)
    hot = [torch.ones(K15_HOT, **i32), torch.arange(C, C + K15_HOT, **i32),
           torch.zeros(K15_HOT, **i32), torch.ones(K15_HOT, **i32)]
    order = torch.as_tensor(rng.permutation(n + K15_HOT), device=dev)
    co = [torch.cat([a, b])[order].contiguous() for a, b in zip(co, hot)]
    out = {}
    for thr in (0.0, 0.5):
        got = []
        for _ in range(2):
            p = [t.clone() for t in pools]
            K.sync_round(*p, *co, threshold=thr)
            got.append(p)
            check(claims_clear(K), f"K15's heavy round (threshold {thr}) "
                  "left a claim scratch set")
        ref = [t.clone() for t in pools]
        K.sync_round_plain(*ref, *co, threshold=thr)
        check(all(bitwise(a, b) and bitwise(a, c)
                  for a, b, c in zip(got[0], got[1], ref)),
              f"K15's heavy round (threshold {thr}, owner (0, 1) named "
              f"{K15_HOT + 1} times) differs from its plain version or "
              "between two runs")
        del got, ref
        main, cache = pools[0].clone(), pools[1].clone()
        # fresh deltas for the warm-up, four traced calls and four retakes
        deltas = [pools[2].clone() for _ in range(21)]
        fresh = itertools.count()
        calls = one_call_kernels(lambda: K.sync_round(
            main, cache, deltas[next(fresh) % 21], *co, threshold=thr),
            reps=4, us=True)
        out[thr] = dict(rows=n + K15_HOT, call_kernels=calls,
                        ms=sum(u for _, u in calls.values()) / 1e3)
        del main, cache, deltas
    return out


def report_k14_k15(rec):
    """Phase 2's lines of K14 and K15 (those in `rec`)."""
    k14 = rec.get("drop_set")
    if k14 is not None:
        print(f"phase 2: K14, the device records of one set call: "
              f"{k14['call_kernels']}", flush=True)
        for batch, b in (("distinct", k14), ("duplicates", k14["duplicates"])):
            for form, r in b["forms"].items():
                if "ms" not in r:
                    print(f"phase 2: K14 {form} at {r['rows']} entries "
                          f"({batch}, {r['winners']} winners): bitwise its "
                          "plain version and over two runs, the claim "
                          "scratch all -1 after each call (not timed)",
                          flush=True)
                    continue
                lib = "" if r["library_ms"] is None else (
                    f"; index_copy_ of the winners {fmt_t(r, 'library_ms')} "
                    f"ms of device time, {fmt_s(*r['library_event_ms'])} "
                    "between events")
                print(f"phase 2: K14 {form} at {r['rows']} entries ({batch}, "
                      f"{r['winners']} winners) of {L} f32 into {TIER_HOT} "
                      f"rows: {fmt_t(r, 'ms')} ms of device time a call "
                      f"(trace), {fmt_s(*r['event_ms'])} ms between CUDA "
                      f"events (bound {r['bound'][0]:.4f} ms, "
                      f"{r['bound'][1]}, share "
                      f"{r['bound'][0] / r['ms']:.3f}); plain (the parent's "
                      f"set_winners path) {fmt_t(r, 'plain_ms')} ms{lib}; "
                      "bitwise its plain version and over two runs, the "
                      "claim scratch all -1 after each call", flush=True)
    k15 = rec.get("sync_round")
    if k15 is not None:
        for what, r in (("threshold 0", k15), ("half held", k15["held"])):
            print(f"phase 2: K15 at {r['rows']} replica rows of {L} f32, "
                  f"S=2, {what} ({r['shipped']} shipped): "
                  f"{fmt_t(r, 'ms')} ms of device time a round (trace), "
                  f"{fmt_s(*r['event_ms'])} ms between CUDA events (bound "
                  f"{r['bound'][0]:.4f} ms, {r['bound'][1]}, share "
                  f"{r['bound'][0] / r['ms']:.3f}); plain "
                  f"{fmt_t(r, 'plain_ms')} ms; the parent's K1 + K3 + K1 + "
                  f"two sets {fmt_s(*r['parent_ms'])} ms of device time, "
                  f"{fmt_s(*r['parent_event_ms'])} between events; "
                  f"{r['launches_a_round']:g} device records a round "
                  f"against the parent's {r['parent_launches_a_round']:g} "
                  f"({r['call_kernels']}); bitwise its plain version, the "
                  "parent's and over two runs", flush=True)
        print("phase 2: K15 at S=4 (every owner folds three replicas a "
              "round), threshold 0 and half held: bitwise its plain "
              "version and over two runs", flush=True)
        for thr, r in k15["heavy"].items():
            print(f"phase 2: K15's heavy round, {r['rows']} replicas, owner "
                  f"(0, 1) named {K15_HOT + 1} times, threshold {thr}: "
                  f"{r['ms']:.4f} ms of device time ({r['call_kernels']}); "
                  "bitwise its plain version and over two runs, every "
                  "claim scratch all -1", flush=True)
        print(f"phase 2: K15 ptxas {k15['ptxas']}", flush=True)


def report_tier_kernels(rec, names=("gather_cold", "gather_pool_cold",
                                     "write_main_rows", "sync_compress")):
    """Phase 2's lines of K9-K12 (those of `names`)."""
    for name, what in (("gather_cold", f"K9 at {ROWS} entries of {L} f32, "
                                       "a third cold"),
                       ("sync_compress", f"K12 at {TIER_SYNC_ROWS} replica "
                                         f"rows of {L} f32, half held")):
        if name not in names:
            continue
        for mode, r in rec[name]["modes"].items():
            print(f"phase 2: {what}, {mode}: {fmt_t(r, 'ms')} ms (bound "
                  f"{r['bound'][0]:.4f} ms, {r['bound'][1]}, share "
                  f"{r['bound'][0] / r['ms']:.3f}), plain "
                  f"{fmt_t(r, 'plain_ms')} ms, library "
                  f"{fmt_t(r, 'library_ms')} ms; bitwise its plain version "
                  "and over two runs", flush=True)
    if "write_main_rows" in names:
        k11 = rec["write_main_rows"]
        print(f"phase 2: K11, the device records of one call: "
              f"{k11['call_kernels']}", flush=True)
        for batch, b in (("distinct", k11), ("duplicates", k11["duplicates"])):
            for mode, r in b["modes"].items():
                print(f"phase 2: K11 at {r['rows']} entries ({batch}, "
                      f"{r['winners']} winners) of {L} f32 into {TIER_HOT} "
                      f"rows, {mode}: {fmt_t(r, 'ms')} ms of device time a "
                      f"call (trace; the write kernel alone "
                      f"{fmt_s(*r['write_ms'])}), {fmt_s(*r['event_ms'])} ms "
                      f"between CUDA events (bound {r['bound'][0]:.4f} ms, "
                      f"{r['bound'][1]}, share "
                      f"{r['bound'][0] / r['ms']:.3f}); plain "
                      f"{fmt_t(r, 'plain_ms')} ms; index_copy_ of the "
                      f"winners {fmt_t(r, 'library_ms')} ms of device time, "
                      f"{fmt_s(*r['library_event_ms'])} between events; "
                      "bitwise its plain version and over two runs, the "
                      "claim scratch all -1 after each call", flush=True)
    if "gather_pool_cold" not in names:
        return
    k10 = rec["gather_pool_cold"]
    for r in (k10, k10["full_batch"]):
        print(f"phase 2: K10 at a bag batch of {r['requests']} requests "
              f"({r['members']} members, {r['bags']} bags, L={L_DLRM}) "
              f"over {TIER_BAG_HOT} hot rows and int8 cold rows (cold "
              f"member share {r['cold_share']:.3f}): kernel "
              f"{fmt_t(r, 'ms')} ms in the trace (bound {r['bound'][0]:.4f}"
              f" ms, share {r['bound'][0] / r['ms']:.3f}), plain "
              f"{fmt_t(r, 'plain_ms')} ms, embedding_bag over pre-"
              f"dequantized rows {fmt_t(r, 'library_ms')} ms; sum and mean "
              "bitwise its plain version and over two runs", flush=True)
    print(f"phase 2: gather_pool.cu ptxas, K8's and K10's instantiations "
          f"{ptxas_summary('gather_pool')}", flush=True)


class TierCapture:
    """Records every TierManager built while active (the app builds its
    server inside run_app)."""

    def __enter__(self):
        from adapm_tpu_torch.tier import residency
        self.mod, self.made = residency, []
        self.orig = residency.TierManager.__init__

        def init(tm, *a, **kw):
            self.orig(tm, *a, **kw)
            self.made.append(tm)
        residency.TierManager.__init__ = init
        return self

    def __exit__(self, *exc):
        self.mod.TierManager.__init__ = self.orig


TIER_APP_KERNELS = APP_KERNELS + ("gather_cold", "write_main_rows")


def phase_tier_app(K):
    """Phase 13 (a): the KGE app tiered at full width, fp32 and int8 cold
    rows."""
    from adapm_tpu_torch.apps import knowledge_graph_embeddings as kge
    # one eval after the second epoch and the test eval (cut from an
    # eval every epoch: the tiered eval's seconds are settled)
    argv = APP_ARGS + ["--synthetic_triples", str(100 * B), "--epochs", "2",
                       "--eval_every", "2", "--eval_triples", "100",
                       "--scan_steps", str(SCAN_K), "--sys.tier", "1",
                       "--sys.tier.hot_rows", str(TIER_HOT)]
    out = {}
    for mode in ("fp32", "int8"):
        with TierCapture() as cap:
            res, launches = run_app(kge, K, argv + ["--sys.tier.cold_dtype",
                                                    mode])
        what = f"phase 13 (a, {mode})"
        check_app(res, launches, what, TIER_APP_KERNELS)
        losses = res["epoch_losses"]
        check(losses[1] < losses[0], f"{what}: loss did not fall: {losses}")
        check(len(res["eval_s"]) >= 2, f"{what}: {len(res['eval_s'])} evals")
        t = res["tier"]
        check(t["hot_rows_per_shard_max"] <= TIER_HOT,
              f"{what}: {t['hot_rows_per_shard_max']} hot rows in a shard")
        check(t["promotions"] > 0, f"{what}: no promotion")
        check(len(cap.made) == 1 and
              cap.made[0].engine.failures == 0,
              f"{what}: tier maintenance passes failed")
        out[mode] = dict(epoch_s=res["epoch_s"], eval_s=res["eval_s"],
                         gen_s=res["gen_s"], epoch_losses=losses,
                         mrr=res["mrr"], tier=t, launches=launches,
                         replayed=res["replayed"])
    return out


def tier_table(at, dev, mode, seed, tier=True, lockorder=False):
    """Phase 3's table (E + R keys of L f32) with values on an int8 grid
    (the AdaGrad half non-negative), tiered with TIER_HOT hot rows and
    `mode` cold rows, or not; under the lock-order sentinel
    (--sys.lint.lockorder) when `lockorder`."""
    opts = dict(tier=True, tier_hot_rows=TIER_HOT, tier_cold_dtype=mode) \
        if tier else {}
    srv = at.setup(E + R, L, opts=at.SystemOptions(
        cache_slots_per_shard=1, sync_max_per_sec=0,
        lint_lockorder=lockorder, **opts), device=dev)
    w = srv.make_worker(0)
    fill = np.random.default_rng(seed)
    for lo in range(0, E + R, 50_000):
        hi = min(lo + 50_000, E + R)
        vals = grid_rows(fill, hi - lo, L)
        vals[:, L // 2:] = np.abs(vals[:, L // 2:])   # AdaGrad's sums >= 0
        w.set(np.arange(lo, hi), vals)
    srv.block()
    return srv, w


def phase_tier_storm(at, K, dev):
    """Phase 13 (b): test_tier.py's storm at full width on phase 3's
    table: a tiered server (TIER_HOT hot rows) beside an untiered shadow
    on the card, TIER_STORM_OPS ops of pushes with duplicates, sets,
    pulls, promotions, demotions and sync rounds. fp32 cold rows: every
    read bitwise the shadow's; int8: within two grid steps
    (tier/quant.py grid_step). The fp32 storm runs under the lock-order
    sentinel (--sys.lint.lockorder): it must record edges and no
    violation."""
    from adapm_tpu_torch.lint import lockorder
    from adapm_tpu_torch.tier.quant import grid_step
    n = E + R
    out = {}
    for mode in ("fp32", "int8"):
        K.reset_launches()
        sentinel = mode == "fp32"
        lockorder.disable_sentinel()
        srv, w = tier_table(at, dev, mode, 21, lockorder=sentinel)
        ref, wr = tier_table(at, dev, mode, 21, tier=False,
                             lockorder=sentinel)
        rng = np.random.default_rng(22)

        def agree(a, b, what):
            a, b = a.reshape(-1, L), b.reshape(-1, L)
            if mode == "fp32":
                ok = np.array_equal(a.view(np.uint32), b.view(np.uint32))
            else:
                ok = (np.abs(a - b).max(axis=1)
                      <= 2 * grid_step("int8", b) + 1e-6).all()
            check(ok, f"phase 13 (b, {mode}): {what} differs from the "
                  "untiered shadow beyond the contract")

        t0 = time.perf_counter()
        m = min(16384, n // 4)      # keys a promotion, demotion, pull
        for step in range(TIER_STORM_OPS):
            op = step % 6
            if op == 0:
                ks = skewed_keys(rng, n, m // 2)      # heavy duplicates
                v = rng.standard_normal((m // 2, L), np.float32) * 0.01
                w.push(ks, v)
                wr.push(ks, v)
            elif op == 1:
                ks = rng.choice(n, m // 4, replace=False)
                v = grid_rows(rng, m // 4, L)
                w.set(ks, v)
                wr.set(ks, v)
            elif op == 2:
                srv.tier.promote_keys(skewed_keys(rng, n, m))
            elif op == 3:
                srv.tier.demote_keys(rng.choice(n, m, replace=False))
                srv.tier.maintain()
            elif op == 4:
                srv.sync.run_round(force_intents=True, all_channels=True)
                ref.sync.run_round(force_intents=True, all_channels=True)
            else:
                w.advance_clock()
                wr.advance_clock()
            pk = skewed_keys(rng, n, m)
            agree(w.pull_sync(pk), wr.pull_sync(pk), f"op {step} pull")
        srv.quiesce()
        ref.quiesce()
        agree(srv.read_main(np.arange(n)), ref.read_main(np.arange(n)),
              "the whole table after quiesce")
        storm_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        check_launched(launches, f"phase 13 (b, {mode})",
                       ("gather_cold", "write_main_rows"))
        rep = srv.tier.report()
        check(srv.tier.engine.failures == 0,
              f"phase 13 (b, {mode}): tier maintenance passes failed")
        out[mode] = dict(storm_s=storm_s, launches=launches, tier=rep,
                         ef_evicted=int(srv.stores[0].coldq.ef_evicted))
        check_background(srv, f"phase 13 (b, {mode})")
        srv.shutdown()
        ref.shutdown()
        if sentinel:
            sen = lockorder.get_sentinel()
            check(sen is not None and sen.edges() and sen.violations == 0,
                  f"phase 13 (b, {mode}): the lock-order sentinel recorded "
                  f"no edge or a violation")
            out[mode]["sentinel_edges"] = sen.edges()
        lockorder.disable_sentinel()
        torch.cuda.empty_cache()
    return out


def phase_tier_bags(at, K, dev, untiered):
    """Phase 13 (c): phase 10 (b)'s bag path on the DLRM table tiered
    (TIER_BAG_HOT hot rows, int8 cold rows, values on the int8 grid so a
    row reads the same bits hot or cold): the sum segment, every reply
    bitwise pool_bags_host over Worker.pull, K8 or K10 launched once per
    fused batch (K10 where the batch holds a cold member), samples/s
    and p50/p99 beside phase 10's untiered sum segment."""
    from adapm_tpu_torch.serve import ServePlane
    from adapm_tpu_torch.serve.bags import pool_bags_host
    caps, offs = dlrm_table()
    nkeys = int(caps.sum())
    t0 = time.perf_counter()
    srv = at.setup(nkeys, L_DLRM, opts=at.SystemOptions(
        cache_slots_per_shard=1, sync_max_per_sec=0, tier=True,
        tier_hot_rows=TIER_BAG_HOT, tier_cold_dtype="int8"), device=dev)
    w = srv.make_worker(0)
    fill = np.random.default_rng(4)
    for lo in range(0, nkeys, 1 << 20):
        hi = min(lo + (1 << 20), nkeys)
        w.set(np.arange(lo, hi), grid_rows(fill, hi - lo, L_DLRM, 2.0 ** -12))
    srv.block()
    fill_s = time.perf_counter() - t0
    reqs = []
    for ci in range(BAG_CLIENTS):
        rng = np.random.default_rng(200 + ci)
        reqs.append([dlrm_request(rng, caps, offs)
                     for _ in range(BAG_REQUESTS)])
    plane = ServePlane(srv)
    st = srv.stores[0]
    hot0, cold0 = st.tier_hot_hits, st.tier_cold_hits
    K.reset_launches()
    seg = serve_segment(srv, plane, reqs, lambda sess, r: sess.lookup_bags(
        r[0], r[1], pooling="sum", deadline_ms=10_000))
    launches = dict(K.LAUNCHES)
    fused = seg["counts"]["bag_fused_total"]
    check(launches["gather_pool"] + launches["gather_pool_cold"] == fused,
          f"phase 13 (c): K8 {launches['gather_pool']} + K10 "
          f"{launches['gather_pool_cold']} launches for {fused} fused "
          "batches")
    # K8 serves the batches without a cold member, K11 the promotions the
    # lookups' feedback asks for
    check_launched(launches, "phase 13 (c)", ("gather_pool_cold",),
                   allowed=("gather_pool", "write_main_rows"))
    hot, cold = st.tier_hot_hits - hot0, st.tier_cold_hits - cold0
    plane.close()
    for ci, rs in enumerate(reqs):
        # one pull of all the client's members: nothing writes after the
        # segments, so each request's rows are the bits it would pull alone
        rows = w.pull_sync(np.concatenate([ks for tables, _ in rs
                                           for ks in tables]))
        lo = 0
        for i, (tables, bags) in enumerate(rs):
            for t, (ks, bg) in enumerate(zip(tables, bags)):
                mine = rows[lo:lo + len(ks)]
                lo += len(ks)
                seg_ix = np.repeat(np.arange(len(bg) - 1),
                                   np.diff(bg)).astype(np.int32)
                ref = pool_bags_host(mine, seg_ix, len(bg) - 1, "sum")
                check(np.array_equal(seg["replies"][ci][i][t].view(np.uint32),
                                     ref.view(np.uint32)),
                      f"phase 13 (c): request {ci}/{i} table {t} differs "
                      "from pool_bags_host over Worker.pull")
    tier = srv.tier.report()
    check(srv.tier.engine.failures == 0,
          "phase 13 (c): tier maintenance passes failed")
    check_background(srv, "phase 13 (c)")
    srv.shutdown()
    seg.pop("replies")
    seg["samples_per_s"] = seg["per_s"] * DLRM_SAMPLES
    return dict(fill_s=fill_s, segment=seg, launches=launches, tier=tier,
                cold_member_share=cold / max(hot + cold, 1),
                untiered=dict(samples_per_s=untiered["samples_per_s"],
                              p50_ms=untiered["p50_ms"],
                              p99_ms=untiered["p99_ms"]))


def phase_tier_planner(at, K, dev, off):
    """Phase 13 (d): phase 12's background planner with --sys.sync.compress
    fp16 and int8: after quiesce() every row is the sequential sum —
    bitwise in fp16 (the integer deltas are on its grid); in int8 within
    the f32 rounding of the merges: a shipped int8 delta is off the
    integer grid, so each round's merge into the owner row may round
    once, by at most half an ulp, and the exact flush at quiesce cannot
    undo that (rounds x one ulp of the row's largest magnitude, twice
    the final one) — with K12 launched; bytes per round against `off`
    (phase 12)."""
    out = {}
    for mode in ("fp16", "int8"):
        K.reset_launches()
        got, want, rounds_s, created, nbytes = planner_run(
            at, dev, compress=mode)
        launches = dict(K.LAUNCHES)
        tol = nbytes["rounds"] * np.spacing(
            2 * np.abs(want).max(axis=1, keepdims=True))
        if mode == "fp16":
            ok = np.array_equal(got.view(np.uint32), want.view(np.uint32))
        else:
            ok = bool((np.abs(got - want) <= tol).all())
        check(ok, f"phase 13 (d, {mode}): after quiesce the main rows "
              "differ from the sequential sum")
        check_launched(launches, f"phase 13 (d, {mode})",
                       ("sync_compress", "ordered_scatter_add"))
        out[mode] = dict(rounds_s=rounds_s, replicas_created=created,
                         launches=launches, **nbytes,
                         max_abs_diff=float(np.abs(got - want).max()),
                         max_tol=float(tol.max()))
    out["off"] = off
    return out


def phase_episodic(at, K, dev):
    """Phase 13 (e): EpisodicRunner over (a)'s tiered step (phase 3's
    table, fp32 cold rows, TIER_HOT hot rows), EPISODE_B batches an
    episode, against the same step run sequentially on a server filled
    alike: every loss and the whole main table bitwise. The negatives'
    population (the 8,192 most requested entities) is intent-pinned hot
    on both servers first, so the hot-restricted draw is the same in
    both runs. The clocks stand still inside a run, so every step's and
    every prepared episode's pins stay live, and a step that needs more
    hot rows than the unpinned ones evicts pinned rows, lowest access
    score first: the population is pulled a few times first (scores up)
    so that those victims are earlier steps' rows and never its own
    (checked: a population row leaving the hot pool fails the phase)."""
    from adapm_tpu_torch.base import CLOCK_MAX
    from adapm_tpu_torch.device import EpisodicRunner
    from adapm_tpu_torch.models import make_kge_loss
    from adapm_tpu_torch.ops.fused import DeviceRoutedRunner
    pop = np.arange(min(8192, E // 8))
    roles = ("s", "r", "o", "neg")
    runs = []
    for episodic in (True, False):
        srv, w = tier_table(at, dev, "fp32", 31)
        w.intent(pop, 0, CLOCK_MAX)
        srv.wait_sync()
        srv.tier.promote_keys(pop)
        for _ in range(4):
            w.pull_sync(pop)
        runner = DeviceRoutedRunner(
            srv, make_kge_loss("complex"), role_class=dict.fromkeys(roles, 0),
            role_dim=dict.fromkeys(roles, L // 2), neg_role="neg",
            neg_shape=(B, N), neg_population=pop, seed=0)
        batches = kge_batches(np.random.default_rng(32), EPISODE_STEPS)
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if episodic:
            er = EpisodicRunner(runner, episode_batches=EPISODE_B)
            losses = er.run(batches, lr=0.1)
        else:
            losses = [runner(b, None, 0.1) for b in batches]
        losses = [float(x) for x in losses]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = srv.stores[0]
        check(bool((st.res.dev_row[srv.ab.owner[pop],
                                   srv.ab.slot[pop]] >= 0).all()),
              f"phase 13 (e): the negatives' population left the hot pool "
              f"({'episodic' if episodic else 'sequential'} run)")
        launches = dict(K.LAUNCHES)
        table = srv.read_main(np.arange(E + R))
        snap = srv.metrics_snapshot()
        runs.append(dict(losses=losses, wall_s=wall, launches=launches,
                         table=table, episode={k: v for k, v in
                                               snap["episode"].items()
                                               if not isinstance(v, dict)},
                         overlap=snap["exec"].get("overlap_fraction")))
        check(srv.tier.engine.failures == 0,
              "phase 13 (e): tier maintenance passes failed")
        check_background(srv, "phase 13 (e)")
        srv.shutdown()
        torch.cuda.empty_cache()
    e, s = runs
    check(np.array_equal(np.float32(e["losses"]), np.float32(s["losses"])),
          "phase 13 (e): episodic losses differ from the sequential run's")
    check(np.array_equal(e["table"].view(np.uint32),
                         s["table"].view(np.uint32)),
          "phase 13 (e): the main table differs from the sequential run's")
    check(e["episode"].get("episodes_total") == EPISODE_STEPS // EPISODE_B,
          f"phase 13 (e): {e['episode']}")
    check_launched(e["launches"], "phase 13 (e)",
                   STEP_KERNELS + ("write_main_rows",))
    for r in runs:
        r.pop("table")
    return dict(episodic=e, sequential=s)


def report_tier_app(app, smi):
    """Phase 13's lines (a part each), with the card's nvidia-smi line."""
    for mode, r in app.items():
        t = r["tier"]
        print(f"phase 13 (a, {mode} cold rows): app epochs "
              f"{[round(x, 3) for x in r['epoch_s']]} s, evals "
              f"{[round(x, 3) for x in r['eval_s']]} s, losses "
              f"{r['epoch_losses']}, MRR {r['mrr']:.4g}; hot rows max "
              f"{t['hot_rows_per_shard_max']} of {TIER_HOT}, promotions "
              f"{t['promotions']}, demotions {t['demotions']}, hot hit rate "
              f"{t['hot_hit_rate']:.4f}, cold bytes/row "
              f"{t['cold_bytes_per_row']:.1f}, residual rows "
              f"{t['ef_resid_rows']} (evicted {t['ef_evicted']}); launches "
              f"{r['launches']}, replayed {r['replayed']} [{smi}]",
              flush=True)


def report_tier_storm(storm, smi):
    for mode, r in storm.items():
        print(f"phase 13 (b, {mode}): storm of {TIER_STORM_OPS} ops over "
              f"{E + R} keys in {r['storm_s']:.2f} s, reads "
              f"{'bitwise' if mode == 'fp32' else 'within two grid steps'}"
              f" the untiered shadow"
              + (f", under the lock-order sentinel: edges "
                 f"{r['sentinel_edges']}, no violation"
                 if "sentinel_edges" in r else "")
              + f"; tier {r['tier']}, residuals evicted "
              f"{r['ef_evicted']}; launches {r['launches']} [{smi}]",
              flush=True)


def report_tier_bags(bags, smi):
    s, u = bags["segment"], bags["untiered"]
    print(f"phase 13 (c): tiered bag path (int8, {TIER_BAG_HOT} hot rows, "
          f"fill {bags['fill_s']:.1f} s): {s['samples_per_s']:.0f} samples/s"
          f", p50/p99 {s['p50_ms']:.2f} / {s['p99_ms']:.2f} ms, mean batch "
          f"{s['mean_batch']:.2f}, cold member share "
          f"{bags['cold_member_share']:.3f}; untiered (phase 10 sum) "
          f"{u['samples_per_s']:.0f} samples/s, {u['p50_ms']:.2f} / "
          f"{u['p99_ms']:.2f} ms; launches {bags['launches']}; tier "
          f"{bags['tier']} [{smi}]", flush=True)


def report_tier_planner(planner, smi):
    for mode in ("fp16", "int8"):
        r, o = planner[mode], planner["off"]
        print(f"phase 13 (d, {mode}): planner {r['rounds_s']:.1f} rounds/s, "
              f"bytes shipped {r['bytes_shipped']} of "
              f"{r['bytes_full_equiv']} full-width ({r['bytes_shipped'] / max(r['bytes_full_equiv'], 1):.3f}); "
              f"off: {o['bytes_shipped']} bytes; last round "
              f"{r['bytes_per_round']} bytes; residual norm "
              f"{r['ef_residual_norm']:.3g}; max |diff| to the sum "
              f"{r['max_abs_diff']:.3g} (bound {r['max_tol']:.3g}, "
              f"{r['rounds']} rounds); launches {r['launches']} [{smi}]",
              flush=True)


def report_episodic(epi, smi):
    e, q = epi["episodic"], epi["sequential"]
    print(f"phase 13 (e): EpisodicRunner, {EPISODE_STEPS} steps in episodes "
          f"of {EPISODE_B}: losses and the main table bitwise the "
          f"sequential run; {e['wall_s']:.3f} s against {q['wall_s']:.3f} "
          f"s; episode {e['episode']}; exec overlap {e['overlap']}; "
          f"launches {e['launches']} [{smi}]", flush=True)


def fmt_t(r, key):
    v = r[key]
    if v is None:
        return "none"
    return fmt_s(v, *r[key + "_spread"])


def fmt_s(v, lo, hi):
    """median [min, max]"""
    return f"{v:.4f} [{lo:.4f}, {hi:.4f}]"


def report_kernels(rec):
    """Phase 2's lines: each kernel against its plain version."""
    for name, r in rec.items():
        print(f"phase 2: {name}: {fmt_t(r, 'ms')} ms (bound "
              f"{r['bound'][0]:.4f} ms, {r['bound'][1]}), plain "
              f"{fmt_t(r, 'plain_ms')} ms, library {fmt_t(r, 'library_ms')}"
              f" ms, max_abs_err {r['max_abs_err']}", flush=True)
    k1 = rec["routed_gather"]
    print(f"phase 2: K1 vs index_select, median [min, max] of 20: "
          f"{fmt_t(k1, 'ms')} vs {fmt_t(k1, 'library_ms')} ms between "
          f"events, {fmt_s(*k1['kernel_ms'])} vs "
          f"{k1['library_kernel_ms']:.4f} in the trace; slab (f32) "
          f"{k1['slab_f32']}; multi-segment forms at {ROLE_SPLIT} "
          "bitwise", flush=True)
    report_k3(rec["ordered_scatter_add"])
    report_k4(rec["pool_eval_counts"])
    report_k4_mp(rec["pool_eval_counts"]["mp_form"])
    report_k17(rec["pool_eval_dist"])
    report_k8(rec["gather_pool"])
    report_tier_kernels(rec)
    report_k13(rec["alltoall_put"])
    report_k14_k15(rec)
    report_k16(rec["rescal_step"])
    k5 = rec["complex_step"]
    print(f"phase 2: K5 at B={B}, N={N}, d={D_MODEL}: {fmt_t(k5, 'ms')} ms "
          f"(bound {k5['bound'][0]:.4f} ms, share "
          f"{k5['bound'][0] / k5['ms']:.3f}); the parent's eager model math "
          f"(autograd + 4 K2) {fmt_s(*k5['eager_ms'])} ms; plain "
          f"{fmt_t(k5, 'plain_ms')} ms; max abs err per (T, l2) "
          f"{k5['forms']}; deterministic, K2 on its gradient bitwise its "
          f"update rows; ptxas {k5['ptxas']}", flush=True)
    for name, what in (("sgns_step", f"K6 at B={B_W2V}, N={N_W2V}, "
                                     f"d={D_W2V} ({W2V_ROWS} rows)"),
                       ("mf_step", f"K7 at B={B_MF}, rank {MF_RANK}, "
                                   "l2=0.01")):
        r = rec[name]
        print(f"phase 2: {what}: kernel {fmt_t(r, 'ms')} ms in the trace "
              f"(bound {r['bound'][0]:.4f} ms, {r['bound'][1]}, share "
              f"{r['bound'][0] / r['ms']:.3f}), L2-cold "
              f"{fmt_s(*r['cold_ms'])} ms (share "
              f"{r['bound'][0] / r['cold_ms'][0]:.3f}), the wrapper call "
              f"between "
              f"events {fmt_s(*r['call_ms'])} ms; the parent's eager model "
              f"math (autograd + one K2 per role) {fmt_s(*r['eager_ms'])} "
              f"ms between events, {r['eager_device_ms']:.4f} ms of device "
              f"time; plain {fmt_t(r, 'plain_ms')} ms, "
              f"{r['plain_device_ms']:.4f} ms of device time; max abs err "
              f"{r.get('forms', r['max_abs_err'])}; deterministic, K2 on its "
              f"gradient bitwise its update rows; ptxas {r['ptxas']}",
              flush=True)


def report_k3(k3):
    """K3's phase-2 lines at the main path's rows."""
    print(f"phase 2: K3 at {ROWS} rows of {L} f32: {fmt_t(k3, 'ms')} ms "
          f"(bound {k3['bound'][0]:.4f} ms, share "
          f"{k3['bound'][0] / k3['ms']:.3f}; before column slabs "
          f"{K3_PRIOR_MS} ms, not measured here); index_add_ "
          f"{fmt_t(k3, 'library_ms')} ms; fold "
          f"grid {k3['grid']}; ptxas {k3['ptxas']}", flush=True)
    print(f"phase 2: K3 three ways (zipf keys, longest run "
          f"{k3['longest_run']}): wrapper {fmt_t(k3, 'ms')}"
          f" ms; fold alone {fmt_s(*k3['fold_ms'])} ms (bound "
          f"{k3['fold_bound'][0]:.4f} ms, share "
          f"{k3['fold_bound'][0] / k3['fold_ms'][0]:.3f}); ordering pass "
          f"(flat targets + sort) {fmt_s(*k3['order_ms'])} ms; torch.sort "
          f"alone {fmt_s(*k3['sort_ms'])} ms; uniform keys (longest run "
          f"{k3['uniform_longest_run']}) {fmt_s(*k3['uniform_ms'])} ms "
          f"(bound {k3['uniform_bound'][0]:.4f} ms); multi-segment form at "
          f"{ROLE_SPLIT} bitwise; deterministic over two runs", flush=True)


def report_k8(k8):
    """K8's phase-2 lines: the path's batch, then the full one."""
    for r in (k8, k8["full_batch"]):
        print(f"phase 2: K8 at a bag batch of {r['requests']} requests x "
              f"{DLRM_SAMPLES} samples ({r['members']} members, "
              f"{r['distinct_rows']} distinct rows, {r['bags']} bags, "
              f"L={L_DLRM}): kernel {fmt_t(r, 'ms')} ms in the trace, "
              f"{fmt_s(*r['event_ms'])} ms between CUDA events (bound "
              f"{r['bound'][0]:.4f} ms, {r['bound'][1]}, share "
              f"{r['bound'][0] / r['ms']:.3f}); mean "
              f"{fmt_s(*r['mean_trace_ms'])} ms; a quarter replica-served "
              f"(S=2) {fmt_s(*r['replica_trace_ms'])} ms (bound "
              f"{r['replica_bound'][0]:.4f} ms, share "
              f"{r['replica_bound'][0] / r['replica_trace_ms'][0]:.3f}); "
              f"plain {fmt_t(r, 'plain_ms')} ms; embedding_bag(sum) "
              f"{fmt_t(r, 'library_ms')} ms (max abs diff to K8 "
              f"{r['library_max_abs_diff']:.3g}); before the redesign "
              f"{r['prior_ms']} ms (quoted from PERF.md, not measured in "
              f"this run); longest bag {r['longest_bag']}, "
              f"the same members in bags of equal length "
              f"{r['equal_bag_sizes']} {fmt_s(*r['equal_ms'])} ms; bitwise "
              f"its plain version and over two runs in every form "
              f"{r['forms_err']}", flush=True)
    print(f"phase 2: K8 ptxas {k8['ptxas']}; profiler traces retaken so "
          f"far {TRACE_RETAKES}", flush=True)


def report_k4(k4):
    """K4's lines: each form and batch against its plain version, its
    share of the bound, the launch plans and what ptxas reported."""
    for form, r in k4["forms"].items():
        print(f"phase 2: K4 {form} K={r['K']}: {fmt_t(r, 'ms')} ms (bound "
              f"{r['bound'][0]:.4f} ms, {r['bound'][1]}, share "
              f"{r['bound'][0] / r['ms']:.3f}), plain "
              f"{fmt_t(r, 'plain_ms')} ms, matmul+compare+sum "
              f"{fmt_t(r, 'library_ms')} ms, count diff {r['max_abs_err']}"
              f" within {r['ties']} near-ties, {r['counted']} counted",
              flush=True)
    print(f"phase 2: K4 exact on integer data at B={K4_BATCHES}: "
          f"{k4['exact_counted']} counted, equal to the plain version",
          flush=True)
    for key, p in k4.get("plans", {}).items():
        print(f"phase 2: K4 plan {key}: {p}", flush=True)
    for e in k4["ptxas"]:
        print(f"phase 2: K4 ptxas {e}", flush=True)
    c = k4["cell"]
    b_ms = c["bound"][0]
    for name, runs in c["ms"].items():
        print(f"phase 2: K4 at the cell's shape (E={c['E']}, K={c['K']}, "
              f"L={c['L']}, B={c['B']}), {name}: "
              + ", ".join(fmt_s(*t) for t in runs)
              + f" ms (rounds 1, 2; bound {b_ms:.4f} ms, {c['bound'][1]}, "
              f"share {b_ms / np.median([t[0] for t in runs]):.3f}); "
              f"plan {c['plans'][name]}", flush=True)
    print(f"phase 2: K4 at the cell's shape: the wrapper's form "
          f"{c['shipped']}, K4_FORMS {c['forms']}, library_ms (matmul + "
          f"compare + sum) {fmt_s(*c['library_ms'])}, every plan's counts "
          f"equal, count diff {c['max_abs_err']} within {c['ties']} "
          f"near-ties of the plain version, {c['counted']} counted",
          flush=True)


def report_main_path(mp, step_launches, path):
    """Phase 3's or 7's lines: the step's speed, launches and device
    profile."""
    ph = path.phase
    from adapm_tpu_torch.exec import dispatch_gate
    from adapm_tpu_torch.lint import lockorder
    check(isinstance(dispatch_gate(), lockorder.SentinelLock)
          and lockorder.get_sentinel() is None,
          f"{ph}: the dispatch gate is not a SentinelLock with the "
          "sentinel off")
    print(f"{ph}: {path.unit} step (the dispatch gate a SentinelLock, the "
          f"sentinel off): fill {mp['fill_s']:.1f} s, "
          f"{mp['ms_per_step']:.3f} ms/step, {mp['per_s']:.0f} "
          f"{path.unit}/s, loss {mp['first_loss']:.5f} -> "
          f"{mp['last_loss']:.5f}, launches {step_launches} (each step "
          f"{mp['per_step']}), peak {mp['peak_mem_gib']:.2f} GiB",
          flush=True)
    prof = mp["profile"]
    if prof is None:
        print(f"{ph}: device time breakdown not measured (the profiler "
              "recorded no device time)", flush=True)
    else:
        print(f"{ph}: profiled {prof['wall_ms_per_step']:.3f} ms/step "
              f"wall, device busy {prof['device_ms_per_step']:.3f} ms/step "
              f"({prof['busy_share']:.3f}), "
              f"{prof['device_ops_per_step']:.1f} device operations "
              f"(kernels, copies, fills) per step; top: " + "; ".join(
                  f"{k} {v:.3f}" for k, v in prof["top_ms_per_step"][:8]),
              flush=True)


def report_scan(sc, path):
    """Phase 3's or 7's run_scan line."""
    prof = sc["profile"]
    busy = "not measured" if prof is None else (
        f"device {prof['device_ms_per_step']:.3f} ms/step, "
        f"{prof['device_ops_per_step']:.1f} device operations/step, busy "
        f"{prof['busy_share']:.3f} of the window's wall; top: " + "; ".join(
            f"{k} {v:.3f}" for k, v in prof["top_ms_per_step"][:6]))
    print(f"{path.phase}: run_scan K={SCAN_K}: 2 windows bitwise equal to "
          f"{2 * SCAN_K} sequential steps (losses and main pool); "
          f"{sc['ms_per_step']:.3f} ms/step ({sc['per_s']:.0f} "
          f"{path.unit}/s) over {SCAN_TIMED} windows vs "
          f"{sc['eager_ms_per_step']:.3f} ms/step for the same eager calls; "
          f"{sc['captures']} capture(s); launches {sc['launches']}, "
          f"replayed {sc['replayed']}; the profiled replay's trace "
          f"{sc['replay_trace']}; profiled window: {busy}", flush=True)


def report_w2v_app(app):
    """Phase 8's lines."""
    a = app["app"]
    steps = sum(a["steps"])
    rates = [round(n * B_W2V / t) for n, t in zip(a["steps"], a["epoch_s"])]
    print(f"phase 8: w2v app: {a['vocab']} words in the corpus, corpus "
          f"{a['corpus_s']:.2f} s, epochs "
          f"{[round(t, 3) for t in a['epoch_s']]} s ({rates} pairs/s), "
          f"steps {a['steps']}, losses {a['epoch_losses']}, "
          f"captures {a['graph_captures']}, device {a['device_s']} s, "
          f"busy share {a['busy_share']}, launches {app['launches']}, "
          f"replayed {a['replayed']} (K6 {steps} = steps); with "
          f"--sys.prefetch 0: epochs "
          f"{[round(t, 3) for t in a['off']['epoch_s']]} s, device "
          f"{a['off']['device_s']} s, busy share "
          f"{a['off']['busy_share']}, losses and launches the same; "
          f"host-routed small config losses cuda {app['small_cuda']} vs "
          f"cpu {app['small_cpu']}", flush=True)
    print("phase 8: host seconds inside: " + "; ".join(
        f"{k} {v:.3f}" for k, v in a["host_seconds"].items()), flush=True)


def report_mf(mfr):
    """Phase 9's lines."""
    for routes in ("device", "host"):
        r = mfr[routes]["res"]
        busy, off_busy = ("", "") if "busy_share" not in r else (
            f", device {r['device_s']} s, busy share {r['busy_share']}",
            f", device {r['off']['device_s']} s, busy share "
            f"{r['off']['busy_share']}")
        print(f"phase 9: MF app ({routes} routes): epochs "
              f"{[round(t, 3) for t in r['epoch_s']]} s, steps {r['steps']}"
              f", losses {r['epoch_losses']}, captures "
              f"{r['graph_captures']}{busy}, launches "
              f"{mfr[routes]['launches']}, replayed {r['replayed']}; with "
              f"--sys.prefetch 0: epochs "
              f"{[round(t, 3) for t in r['off']['epoch_s']]} s{off_busy}, "
              "losses and launches the same", flush=True)
    print(f"phase 9: MF small config cuda vs cpu: device routes "
          f"{mfr['small_device']}, host routes {mfr['small_host']}",
          flush=True)


def report_app_pipeline(app, smi):
    """Phase 5's pipeline lines: the full-width app in turns with the
    pipeline on (the run above) and off, and the --scan_steps 1 runs."""
    for t in app["turns"]:
        print(f"phase 5 (pipeline {t['pipeline']}): epochs "
              f"{[round(x, 3) for x in t['epoch_s']]} s, evals "
              f"{[round(x, 3) for x in t['eval_s']]} s; traced epoch 1: "
              f"{t['traced_epoch_s']} s, device {t['device_s']} s, busy "
              f"share {t['busy_share']} [{smi}]", flush=True)
    print("phase 5 (pipeline): epoch losses bitwise equal in every turn",
          flush=True)
    for name in ("on", "off"):
        r = app["scan1"][name]
        print(f"phase 5 (--scan_steps 1, pipeline {name}): {APP_STEPS1} "
              f"steps, epoch {r['epoch_s'][0]:.3f} s "
              f"({APP_STEPS1 * B / r['epoch_s'][0]:.0f} triples/s), traced "
              f"{r['traced_epoch_s']} s, device {r['device_s']} s, busy "
              f"share {r['busy_share']}, staged-key steps "
              f"{r['staged_steps']}, loss {r['epoch_losses']} [{smi}]",
              flush=True)


def report_pull_flow(pf, smi):
    p = pf["pct_ms"]
    print(f"phase 11: pull-driven flow, {PULL_BATCHES} batches of {B} zipf "
          f"keys (lookahead 2, prefetch_pull auto): staged-hit rate "
          f"{pf['hit_rate']:.3f}; pull p50/p99 {p['on'][0]:.3f} / "
          f"{p['on'][1]:.3f} ms on, {p['off'][0]:.3f} / {p['off'][1]:.3f} "
          f"ms off; K1 launches by staging {pf['staging_k1']} (flow "
          f"launches on {pf['launches_on']}, off {pf['launches_off']}); "
          f"prefetch.report() {pf['report']}; then a staged batch nothing "
          f"wrote pulled as a staged hit, and the batch staged again, "
          f"pushed to and pulled (prefetch.report() at the end "
          f"{pf['final_report']}); every pull bitwise the plain flow's, "
          f"the staged hit and the pull after the push too [{smi}]",
          flush=True)


def report_planner(pl, smi):
    print(f"phase 12: background planner (S=2, two worker threads x "
          f"{PLANNER_RUNS} integer pushes under competing intents): "
          f"{pl['rounds_s']:.1f} rounds/s on cuda ({pl['rounds_s_cpu']:.1f} "
          f"on cpu; the last run before K14 and K15, "
          f"{PLANNER_ROUNDS_S_BEFORE} on cuda, quoted, no target), "
          f"{pl['replicas_created']} replicas created, launches "
          f"{pl['launches']}; every row bitwise the sequential sum and the "
          f"cpu run; no background round failed [{smi}]", flush=True)


# ---------------------------------------------------------------------------
# phase 14: checkpoint chains, fault injection, request-flight tracing
# ---------------------------------------------------------------------------

# the injected server's plane: transient faults at three points, seeded
# so the first base save's first attempt fires (per-point seeded draws)
FAULT_SPEC = "exec.dispatch=0.05,sync.round=0.3,ckpt.save=0.5"
FAULT_SEED = 5
# steps before the base link, before each delta, and past the last save
FAULT_STEPS = (16, 8, 8, 8)
FAULT_DIR = os.path.join("build", "phase14")   # links, trace (removed)
REPORT_S = 0.2                      # (e): --sys.metrics.report seconds
DEGRADED_HOLD_S = 0.5               # (b): restore_chain(hold_degraded_s)
SAVE_ATTEMPTS = 20


class LogTap:
    """Stdout filter for phase 14: the planes' own log lines (`[sync]`,
    `[exec]`, `[ckpt]`, `[metrics r0]` from adapm_tpu_torch's alog) are
    counted and kept, not printed (injected faults log one line each);
    every other line passes through."""

    PREFIXES = ("[sync]", "[exec]", "[ckpt]", "[metrics r0]")

    def __init__(self):
        import threading
        self.lines = {p: [] for p in self.PREFIXES}
        self._lock = threading.Lock()
        self._buf = ""

    def __enter__(self):
        self._out = sys.stdout
        sys.stdout = self
        return self

    def __exit__(self, *exc):
        sys.stdout = self._out
        if self._buf:
            self._out.write(self._buf)
        self._out.flush()

    def write(self, s):
        with self._lock:
            self._buf += s
            *done, self._buf = self._buf.split("\n")
            for ln in done:
                body = ln.split("] ", 1)[1] if ln.startswith("[") and \
                    "] " in ln else ""
                hit = next((p for p in self.PREFIXES
                            if body.startswith(p)), None)
                if hit is None:
                    self._out.write(ln + "\n")
                else:
                    self.lines[hit].append(ln)
        return len(s)

    def flush(self):
        self._out.flush()


def fault_train(srv, w, runner, batches, i0, n):
    """n steps of the main path (intent -> step -> drive_rounds ->
    advance_clock) from batch i0, the background planner running;
    returns the losses on the host."""
    intents = [np.unique(np.concatenate(list(b.values()))) for b in batches]
    srv.start_sync_thread()
    losses = []
    for i in range(i0, i0 + n):
        nxt = (i + 1) % len(batches)
        w.intent(intents[nxt], w.current_clock + 1, w.current_clock + 2)
        losses.append(runner(batches[i % len(batches)], None, 0.1))
        srv.drive_rounds()
        w.advance_clock()
    srv.stop_sync_thread()
    if srv.prefetch is not None:
        srv.prefetch.flush()
    torch.cuda.synchronize()
    return torch.stack(losses).cpu()


def pools_host(srv):
    st = srv.stores[0]
    return [st.main_host(), st.cache.cpu().numpy().copy(),
            st.delta.cpu().numpy().copy(), srv.ab.owner.copy(),
            srv.ab.slot.copy(), srv.ab.cache_slot.copy(),
            srv._clocks.copy()]


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def save_link(ck, fault_cls, K):
    """One chain link; an injected transient fault is retried, anything
    else fails the run. Returns (entry, attempts, seconds, K1 launches
    during the successful capture)."""
    for attempt in range(1, SAVE_ATTEMPTS + 1):
        k1 = K.LAUNCHES["routed_gather"]
        t0 = time.perf_counter()
        try:
            entry = ck.save()
        except fault_cls:
            continue
        return (entry, attempt, time.perf_counter() - t0,
                K.LAUNCHES["routed_gather"] - k1)
    check(False, f"phase 14: a chain save failed {SAVE_ATTEMPTS} times "
          f"in a row on injected faults")


def fault_replica_drill(at, dev):
    """(a), the dirty replicas: phase 4's two-shard setup (competing
    intents put replicas on shard 0), a base link, pushes to replicated
    keys, a delta link that must carry their dirty (cache, delta) rows;
    the chain restores bitwise into a fresh two-shard server."""
    from adapm_tpu_torch.fault import IncrementalCheckpointer, restore_chain
    e, r, d = 512, 16, 8
    path = os.path.join(FAULT_DIR, "replica_chain")

    def mk():
        return at.setup(e + r, 4 * d, num_shards=2, num_workers=2,
                        device=dev, opts=at.SystemOptions(
                            sync_max_per_sec=0, cache_slots_per_shard=256))

    rng = np.random.default_rng(7)
    srv = mk()
    w0, w1 = srv.make_worker(0), srv.make_worker(1)
    w0.wait(w0.set(np.arange(e + r), rng.normal(
        size=(e + r, 4 * d)).astype(np.float32)))
    hot = np.arange(0, e + r, 2)
    w1.intent(hot, 0, 10_000)
    srv.wait_sync()
    w0.intent(hot, 0, 10_000)
    srv.wait_sync()
    ck = IncrementalCheckpointer(srv, path)
    ck.save()
    w0.wait(w0.push(hot[:64], np.ones((64, 4 * d), np.float32)))
    delta = ck.save()
    with np.load(os.path.join(path, delta["file"])) as z:
        dirty = int(len(z["rsh_0"]))
    want = [w.pull_sync(np.arange(e + r)) for w in (w0, w1)]
    srv.shutdown()
    dst = mk()
    ws = [dst.make_worker(0), dst.make_worker(1)]
    restore_chain(dst, path)
    got = [w.pull_sync(np.arange(e + r)) for w in ws]
    dst.shutdown()
    check(dirty > 0, "phase 14 (a): the delta link carries no dirty "
          "replica rows")
    check(all(same_bits(a, b) for a, b in zip(want, got)),
          "phase 14 (a): the replica chain did not restore bitwise")
    return dict(dirty_replica_rows=dirty, delta_bytes=delta["bytes"],
                delta_slots=delta["slots"])


def fault_chain_drill(at, K, dev):
    """(a): the chain drill at full width (see the phase's doc). Returns
    the record, the chain's directory and the shadow (at the state of
    the chain's last link plus FAULT_STEPS[3] steps) for (b)."""
    from adapm_tpu_torch.fault import (IncrementalCheckpointer,
                                       InjectedFault, restore_chain)
    path = os.path.join(FAULT_DIR, "chain")
    batches = kge_batches(np.random.default_rng(14), 4)
    K.reset_launches()
    inj, wi, ri = kge_server(at, dev, 14, fault_spec=FAULT_SPEC,
                             fault_seed=FAULT_SEED, fault_retries=10,
                             fault_backoff_ms=1.0)
    sh, ws, rs = kge_server(at, dev, 14)
    ck = IncrementalCheckpointer(inj, path)
    links, i0 = [], 0
    for n in FAULT_STEPS[:3]:
        li = fault_train(inj, wi, ri, batches, i0, n)
        ls = fault_train(sh, ws, rs, batches, i0, n)
        check(same_bits(li.numpy(), ls.numpy()), "phase 14 (a): the "
              "injected server's losses differ from its shadow's")
        i0 += n
        links.append(save_link(ck, InjectedFault, K))
    at_save = pools_host(sh)
    # the steps past the last save: lost with the server
    fault_train(inj, wi, ri, batches, i0, FAULT_STEPS[3])
    fstats = inj.fault.stats()
    xstats = inj.exec.fault_stats()
    inj.shutdown()
    fired = {p: v["fired"] for p, v in fstats["points"].items()}
    check(all(fired.get(p, 0) > 0 for p in
              ("exec.dispatch", "sync.round", "ckpt.save")),
          f"phase 14 (a): an inert fault plane (fired {fired})")
    check(xstats["retries"] > 0 and fstats["loop_retries"] > 0,
          f"phase 14 (a): injected faults were not retried ({xstats}, "
          f"loop retries {fstats['loop_retries']})")
    check(sum(a for _, a, _, _ in links) > len(links),
          "phase 14 (a): no chain save was retried")
    rest, wr, rr = kge_server(at, dev, None)
    t0 = time.perf_counter()
    recovery_s = restore_chain(rest, path)
    restore_wall_s = time.perf_counter() - t0
    got = pools_host(rest)
    names = ("main", "cache", "delta", "owner", "slot", "cache_slot",
             "clocks")
    bad = [nm for nm, a, b in zip(names, got, at_save)
           if not same_bits(a, b)]
    check(not bad, f"phase 14 (a): restored {bad} differ from the shadow "
          f"at the last save")
    snap = rest.metrics_snapshot()["ckpt"]
    check(snap.get("recovery_s") == recovery_s,
          "phase 14 (a): recovery_s missing from the ckpt section")
    # the same steps on both from here, their generators seeded alike
    rr._gen.manual_seed(1414)
    rs._gen.manual_seed(1414)
    lr_ = fault_train(rest, wr, rr, batches, i0, 8)
    ls_ = fault_train(sh, ws, rs, batches, i0, 8)
    check(same_bits(lr_.numpy(), ls_.numpy()), "phase 14 (a): losses after "
          "the restore differ from the shadow's")
    check(same_bits(rest.stores[0].main_host(), sh.stores[0].main_host()),
          "phase 14 (a): the table after the restore's steps differs from "
          "the shadow's")
    rest.shutdown()
    launches = dict(K.LAUNCHES)
    check_launched(launches, "phase 14 (a)", STEP_KERNELS)
    rep = fault_replica_drill(at, dev)
    out = dict(links=[dict(kind=e["kind"], bytes=e["bytes"],
                           slots=e["slots"], attempts=a, save_s=s,
                           k1_launches=k1)
                      for e, a, s, k1 in links],
               recovery_s=recovery_s, restore_wall_s=restore_wall_s,
               fired=fired, exec_retries=xstats["retries"],
               loop_retries=fstats["loop_retries"],
               save_retries=sum(a - 1 for _, a, _, _ in links),
               launches=launches, replica=rep,
               losses_after=[float(x) for x in lr_])
    return out, path, (sh, ws), at_save


def chain_rows(at_save, keys):
    """The chain's rows of `keys` (its last link's table and placement)."""
    main, _, _, owner, slot = at_save[:5]
    return main[owner[keys], slot[keys]]


def fault_degraded(at, K, dev, path, shadow, at_save):
    """(b): concurrent flat lookups on the shadow while restore_chain
    (hold_degraded_s) replaces its state with the chain's: every outcome
    is ServeDegradedError or a reply bitwise Worker.pull before the
    restore or the chain's rows, and after the window lookups and
    Worker.pull read the chain's rows."""
    import threading
    from adapm_tpu_torch.fault import restore_chain
    from adapm_tpu_torch.serve import ServeDegradedError, ServePlane
    srv, w = shadow
    kr = np.random.default_rng(21)
    keys = [skewed_keys(kr, E + R, 64) for _ in range(16)]
    before = [w.pull_sync(k).tobytes() for k in keys]
    after = [chain_rows(at_save, k).tobytes() for k in keys]
    plane = ServePlane(srv)
    K.reset_launches()
    outcomes, errors = [], []     # "shed", "before", "after" or "other"
    stop = threading.Event()

    def client(ci):
        sess = plane.session()
        i = ci
        while not stop.is_set():
            j = i % len(keys)
            try:
                got = sess.lookup(keys[j], deadline_ms=5000).tobytes()
                outcomes.append("before" if got == before[j] else
                                "after" if got == after[j] else "other")
            except ServeDegradedError:
                outcomes.append("shed")
                time.sleep(0.001)   # a shed is instant: do not spin
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))
            i += 1

    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    t0 = time.perf_counter()
    recovery_s = restore_chain(srv, path, hold_degraded_s=DEGRADED_HOLD_S)
    window_s = time.perf_counter() - t0
    time.sleep(0.05)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    check(not any(t.is_alive() for t in threads), "phase 14 (b): a client "
          "hung")
    check(not errors, f"phase 14 (b): lookups failed: {errors[:3]}")
    sess = plane.session()
    post = [(sess.lookup(k).tobytes(), w.pull_sync(k).tobytes())
            for k in keys]
    plane.close()
    launches = dict(K.LAUNCHES)
    n = {k: outcomes.count(k) for k in ("shed", "before", "after",
                                         "other")}
    check(n["shed"] > 0, "phase 14 (b): no lookup was shed in the "
          "degraded window")
    check(n["other"] == 0, f"phase 14 (b): {n['other']} replies matched "
          f"neither Worker.pull before the restore nor the chain's rows")
    check(all(a == b == c for (a, b), c in zip(post, after)),
          "phase 14 (b): after the window a lookup or Worker.pull differs "
          "from the chain's rows")
    check_launched(launches, "phase 14 (b)", ("routed_gather",))
    srv.shutdown()
    return dict(outcomes=len(outcomes), shed=n["shed"],
                before=n["before"], after=n["after"],
                recovery_s=recovery_s, window_s=window_s,
                launches=launches)


def fault_tiered(at, K, dev, path, at_save):
    """(c): the chain restored into a tiered server (TIER_HOT hot rows,
    fp32 cold rows): everything cold after the restore; pulls of zipf
    batches (K9 on the cold rows), their promotion (K11) and pulls again
    bitwise the chain's rows; the whole table bitwise."""
    from adapm_tpu_torch.fault import restore_chain
    srv, w = kge_table(at, dev, None, tier=True, tier_hot_rows=TIER_HOT)
    K.reset_launches()
    recovery_s = restore_chain(srv, path)
    st = srv.stores[0]
    check(bool((st.res.dev_row < 0).all()), "phase 14 (c): rows hot after "
          "the restore")
    kr = np.random.default_rng(31)
    for _ in range(4):
        keys = skewed_keys(kr, E + R, 16_384)
        want = chain_rows(at_save, keys)
        check(same_bits(w.pull_sync(keys), want), "phase 14 (c): a cold "
              "pull differs from the chain's table")
        srv.tier.promote_keys(keys)
        check(same_bits(w.pull_sync(keys), want), "phase 14 (c): a pull "
              "after promotion differs from the chain's table")
    allk = np.arange(E + R)
    got = srv.read_main(allk).reshape(E + R, L)
    check(same_bits(got, chain_rows(at_save, allk)),
          "phase 14 (c): the tiered table differs from the chain's")
    launches = dict(K.LAUNCHES)
    check_launched(launches, "phase 14 (c)", ("gather_cold",
                                               "write_main_rows"))
    hot = int((st.res.dev_row >= 0).sum())
    srv.shutdown()
    return dict(recovery_s=recovery_s, launches=launches, hot_rows=hot)


def flight_chains(doc, n):
    """Every served lookup's flow in the exported trace: mint -> queue
    -> batch window -> program -> reply (five steps), each step inside a
    slice of its phase that lists the id; every device slice above zero
    and no longer than its program slice."""
    from adapm_tpu_torch.obs.flight import FLIGHT_PHASES
    chains, slices = {}, {p: [] for p in FLIGHT_PHASES + ("flight.device",)}
    for e in doc["traceEvents"]:
        if e.get("ph") in ("s", "t", "f") and e.get("cat") == "flight":
            chains.setdefault(e["id"], []).append(e)
        elif e.get("ph") == "X" and e["name"] in slices:
            slices[e["name"]].append(e)
    check(len(chains) == n and doc["adapm_flight"]["complete_flows"] == n,
          f"phase 14 (d): {len(chains)} complete flows for {n} lookups")
    member = {p: {} for p in slices}
    for p, evs in slices.items():
        for e in evs:
            for tid in e["args"]["traces"]:
                member[p].setdefault(tid, []).append(e)
    for tid, evs in chains.items():
        check([e["ph"] for e in evs] == ["s", "t", "t", "t", "f"],
              f"phase 14 (d): flow {tid} is not one connected chain")
        for p, ev in zip(FLIGHT_PHASES, evs):
            check(any(sl["tid"] == ev["tid"] and sl["ts"] - 1e-3 <= ev["ts"]
                      <= sl["ts"] + sl["dur"] + 1e-3
                      for sl in member[p].get(tid, ())),
                  f"phase 14 (d): flow {tid}'s {p} step lies in no {p} "
                  f"slice that lists it")
        check(tid in member["flight.device"], f"phase 14 (d): lookup {tid} "
              f"has no device slice")
    dev_s, prog_s = slices["flight.device"], slices["flight.program"]
    check(len(dev_s) == len(prog_s) and all(
        0 < d["dur"] <= p["dur"] + 1e-3 for d, p in zip(dev_s, prog_s)),
        "phase 14 (d): a device slice is empty or longer than its program")
    return len(prog_s)


def fault_flight(at, K, dev, tap):
    """(d) and (e): phase 10's flat segment (SERVE_CLIENTS clients x
    SERVE_LOOKUPS lookups of 64 zipf keys) untraced, then on a server
    with --sys.trace.flight 1 and --sys.metrics.report REPORT_S: replies
    bitwise Worker.pull, the exported flows complete, device_s above
    zero, the breakdown histograms' p50/p99; reporter lines logged."""
    from adapm_tpu_torch.obs.metrics import hist_percentile
    from adapm_tpu_torch.serve import ServePlane
    gens = [np.random.default_rng(100 + ci) for ci in range(SERVE_CLIENTS)]
    reqs = [[skewed_keys(g, E + R, 64) for _ in range(SERVE_LOOKUPS)]
            for g in gens]

    def call(sess, keys):
        return sess.lookup(keys, deadline_ms=1000)

    out = {}
    trace_path = os.path.join(FAULT_DIR, "flight.trace.json")
    for traced in (False, True):
        opts = dict(trace_flight=True, trace_flight_out=trace_path,
                    metrics_report_s=REPORT_S) if traced else {}
        n_rep = len(tap.lines["[metrics r0]"])
        srv, w = kge_table(at, dev, 5, **opts)
        plane = ServePlane(srv)
        K.reset_launches()
        seg = serve_segment(srv, plane, reqs, call)
        launches = dict(K.LAUNCHES)
        plane.close()
        check_launched(launches, "phase 14 (d)", ("routed_gather",))
        for ci in range(0, SERVE_CLIENTS, 8):
            for keys, got in list(zip(reqs[ci], seg["replies"][ci]))[:10]:
                check(same_bits(got, w.pull_sync(keys)), "phase 14 (d): a "
                      "lookup differs from Worker.pull")
        seg.pop("replies")
        seg["launches"] = launches
        if traced:
            snap = srv.metrics_snapshot()["flight"]
            doc = json.load(open(srv.write_flight_trace()))
            seg["batches"] = flight_chains(doc, seg["requests"])
            seg["breakdown_ms"] = {
                h: (hist_percentile(snap[h], 0.5) * 1e3,
                    hist_percentile(snap[h], 0.99) * 1e3)
                for h in ("queue_s", "batch_wait_s", "dispatch_s",
                          "device_s")}
            check(snap["device_s"]["count"] == seg["requests"] and
                  snap["device_s"]["sum"] > 0, "phase 14 (d): "
                  "flight.device_s is not above 0 for every lookup")
        srv.shutdown()
        if traced:
            seg["reporter_lines"] = len(tap.lines["[metrics r0]"]) - n_rep
            check(seg["reporter_lines"] >= 1, "phase 14 (e): the metrics "
                  "reporter logged no line")
            seg["reporter_sample"] = tap.lines["[metrics r0]"][-1]
        out["traced" if traced else "plain"] = seg
    return out


def phase_fault(at, K, dev):
    """Phase 14 (a)-(e); the chain's links, the flight trace and the
    replica drill's links live under FAULT_DIR and are removed after."""
    import shutil
    shutil.rmtree(FAULT_DIR, ignore_errors=True)
    os.makedirs(FAULT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    try:
        with LogTap() as tap:
            chain, path, shadow, at_save = fault_chain_drill(at, K, dev)
            degraded = fault_degraded(at, K, dev, path, shadow, at_save)
            tiered = fault_tiered(at, K, dev, path, at_save)
            del at_save
            flight = fault_flight(at, K, dev, tap)
        logged = {p: len(v) for p, v in tap.lines.items()}
    finally:
        shutil.rmtree(FAULT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(chain=chain, degraded=degraded, tiered=tiered,
                flight=flight, logged=logged,
                wall_s=time.perf_counter() - t0)


def report_fault(fr, smi):
    c = fr["chain"]
    links = "; ".join(
        f"{ln['kind']} {ln['bytes'] / 2**20:.1f} MiB {ln['slots']} slots "
        f"{ln['save_s']:.2f} s (attempts {ln['attempts']}, K1 "
        f"{ln['k1_launches']})" for ln in c["links"])
    print(f"phase 14 (a): [{smi}] chain {links}; recovery_s "
          f"{c['recovery_s']:.3f} (wall {c['restore_wall_s']:.3f}); faults "
          f"fired {c['fired']}, executor retries {c['exec_retries']}, loop "
          f"retries {c['loop_retries']}, save retries {c['save_retries']}; "
          f"restored pools bitwise the shadow's, 8 more steps bitwise; "
          f"replica drill: {c['replica']['dirty_replica_rows']} dirty "
          f"replica rows in a {c['replica']['delta_bytes']} B delta; "
          f"launches { {k: v for k, v in c['launches'].items() if v} }",
          flush=True)
    d = fr["degraded"]
    print(f"phase 14 (b): {d['outcomes']} lookups during restore_chain "
          f"(hold {DEGRADED_HOLD_S} s, window {d['window_s']:.3f} s, "
          f"recovery_s {d['recovery_s']:.3f}): {d['shed']} shed "
          f"ServeDegradedError, {d['before']} bitwise before, {d['after']} "
          f"bitwise after", flush=True)
    t = fr["tiered"]
    print(f"phase 14 (c): tiered restore recovery_s {t['recovery_s']:.3f}, "
          f"reads bitwise, {t['hot_rows']} rows promoted, launches "
          f"{ {k: v for k, v in t['launches'].items() if v} }", flush=True)
    p, q = fr["flight"]["plain"], fr["flight"]["traced"]
    bd = ", ".join(f"{h} {a:.3f}/{b:.3f}"
                   for h, (a, b) in q["breakdown_ms"].items())
    print(f"phase 14 (d): [{smi}] flat lookups/s untraced {p['per_s']:.0f} "
          f"(p50/p99 {p['p50_ms']:.2f}/{p['p99_ms']:.2f} ms), traced "
          f"{q['per_s']:.0f} (p50/p99 {q['p50_ms']:.2f}/{q['p99_ms']:.2f} "
          f"ms); {q['requests']} complete flows over {q['batches']} "
          f"batches; breakdown p50/p99 ms: {bd}", flush=True)
    print(f"phase 14 (e): {q['reporter_lines']} reporter lines, last: "
          f"{q['reporter_sample']}", flush=True)
    print(f"phase 14: {fr['wall_s']:.1f} s; log lines kept off stdout "
          f"{fr['logged']}", flush=True)


# phase 15: workload traces, decision telemetry, replay and the policy
REPLAY_STEPS = 8                   # steps per worker thread (cut from
# 64, which took phase 15 to 224 s on the card: ten replays of ~19 s;
# then from 32, 169 s of a 1,036 s run that added phase 16; then from
# 16, 84-119 s of 809-981 s runs, to fit the RESCAL lines)
REPLAY_CLIENTS, REPLAY_LOOKUPS, REPLAY_KEYS = 8, 12, 64
REPLAY_PAUSE_S = 0.1               # a client's pause between lookups
REPLAY_SYNC_PER_S = 20.0           # the capture's background planner
REPLAY_SLO_MS = 2.0                # the capture's --sys.serve.slo_ms
REPLAY_CACHE = 32_768              # cache slots a shard
REPLAY_PREFIX = 96                 # (c): key-batch events on the cpu too
REPLAY_SEED = 11
REPLAY_DIR = os.path.join("build", "phase15")   # traces (removed after)
KEY_KINDS = ("pull", "push", "set", "intent", "serve")
REPLAY_KERNELS = ("routed_gather", "ordered_scatter_add", "gather_cold",
                  "write_main_rows")


def replay_opts(at, capture):
    """Phase 15's server: phase 13's tier (TIER_HOT hot rows a shard,
    fp32 cold rows), the background planner at REPLAY_SYNC_PER_S without
    the static dirty filter (so the learned sync law has a decision to
    veto), the SLO controller, and with `capture` both trace knobs."""
    kw = dict(tier=True, tier_hot_rows=TIER_HOT, tier_cold_dtype="fp32",
              cache_slots_per_shard=REPLAY_CACHE,
              sync_max_per_sec=REPLAY_SYNC_PER_S, sync_report_s=0,
              sync_dirty_only=False, serve_slo_ms=REPLAY_SLO_MS)
    if capture:
        kw.update(trace_workload=os.path.join(REPLAY_DIR, "run.wtrace"),
                  trace_decisions=os.path.join(REPLAY_DIR, "run.dtrace"))
    return at.SystemOptions(**kw)


def replay_workload(at, dev, capture):
    """Phase 15 (a)'s workload on a fresh two-shard server: the table
    filled in B-key sets, then two worker threads (one a shard) of
    REPLAY_STEPS steps (intent for the next batch of B zipf keys, pull
    of the batch, push of B rows, advance_clock) beside REPLAY_CLIENTS
    serving clients (REPLAY_LOOKUPS flat lookups of REPLAY_KEYS zipf
    keys each; even clients tenanted), the background planner running;
    then quiesce and shutdown. Returns the fill and workload seconds
    and the snapshot's wtrace and decision sections."""
    import threading
    from adapm_tpu_torch.serve import ServePlane
    n = E + R
    srv = at.setup(n, L, num_shards=2, num_workers=2, device=dev,
                   opts=replay_opts(at, capture))
    ws = [srv.make_worker(i) for i in range(2)]
    fill = np.random.default_rng(31)
    t0 = time.perf_counter()
    for lo in range(0, n, B):
        hi = min(lo + B, n)
        ws[0].set(np.arange(lo, hi),
                  fill.standard_normal((hi - lo, L), np.float32) * 0.1)
    srv.block()
    fill_s = time.perf_counter() - t0
    plane = ServePlane(srv)
    plane.configure_tenant("gold", priority=1)
    errors = []

    def train(w):
        rng = np.random.default_rng(40 + w.worker_id)
        batches = [np.unique(skewed_keys(rng, n, B))
                   for _ in range(REPLAY_STEPS + 1)]
        vals = rng.standard_normal((B, L), np.float32) * 0.01
        try:
            for i in range(REPLAY_STEPS):
                c = w.current_clock
                w.intent(batches[i + 1], c + 1, c + 2)
                w.pull_sync(batches[i])
                w.wait(w.push(skewed_keys(rng, n, B), vals))
                w.advance_clock()
            w.wait_all()
        except Exception as ex:  # noqa: BLE001 - surface to main thread
            errors.append(f"worker {w.worker_id}: {type(ex).__name__}: "
                          f"{ex}")

    def client(ci):
        rng = np.random.default_rng(60 + ci)
        try:
            sess = plane.session(tenant="gold") if ci % 2 == 0 \
                else plane.session()
            for _ in range(REPLAY_LOOKUPS):
                sess.lookup(skewed_keys(rng, n, REPLAY_KEYS))
                time.sleep(REPLAY_PAUSE_S)
        except Exception as ex:  # noqa: BLE001 - surface to main thread
            errors.append(f"client {ci}: {type(ex).__name__}: {ex}")

    threads = [threading.Thread(target=train, args=(w,)) for w in ws] + \
        [threading.Thread(target=client, args=(ci,))
         for ci in range(REPLAY_CLIENTS)]
    srv.start_sync_thread()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(0.0, t0 + 600 - time.perf_counter()))
    check(not any(t.is_alive() for t in threads),
          "phase 15 (a): a worker or client thread hung")
    check(not errors, f"phase 15 (a): {errors[:3]}")
    srv.stop_sync_thread()
    srv.quiesce()
    if srv.ctx.device.type == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    snap = srv.metrics_snapshot()
    check_background(srv, "phase 15 (a)")
    plane.close()
    srv.shutdown()
    return dict(fill_s=fill_s, wall_s=wall_s, wtrace=snap["wtrace"],
                decision=snap["decision"], rounds=snap["sync"]["rounds"])


def record_cost_ms(at, reps=200):
    """Host milliseconds the recorder takes for one B-key event
    (record_kv: the key list, its crc32 and the append), on a throwaway
    one-shard cpu server."""
    path = os.path.join(REPLAY_DIR, "cost.wtrace")
    srv = at.setup(64, 4, device="cpu", opts=at.SystemOptions(
        sync_max_per_sec=0, trace_workload=path))
    keys = np.unique(skewed_keys(np.random.default_rng(1), E + R, B))
    keys = np.concatenate([keys, keys])[:B]
    t0 = time.perf_counter()
    for _ in range(reps):
        srv.wtrace.record_kv("pull", 0, 0, keys)
    ms = (time.perf_counter() - t0) * 1e3 / reps
    srv.shutdown()
    return ms


def synthesis_ms(tr, n=16):
    """Host milliseconds the replay engine takes to synthesize one push's
    values and keys (its seeded numpy draws), over the trace's first `n`
    pushes, and the trace's push and set events."""
    from types import SimpleNamespace
    from adapm_tpu_torch.replay import ReplayEngine
    eng = ReplayEngine(tr, seed=REPLAY_SEED)
    srv = SimpleNamespace(value_lengths=np.full(E + R, L, np.int64))
    evs = [ev for ev in tr.events if ev["kind"] == "push"]
    t0 = time.perf_counter()
    for ev in evs[:n]:
        eng._vals(srv, ev, eng._keys(ev))
    ms = (time.perf_counter() - t0) * 1e3 / max(1, min(n, len(evs)))
    sets = sum(1 for ev in tr.events if ev["kind"] == "set")
    return dict(ms_per_push=ms, pushes=len(evs), sets=sets)


def replay_part(K, what, fn, kernels=REPLAY_KERNELS):
    """Run one part of phase 15 with the launch counts set to 0 just
    before and read just after; the part must launch its kernels and no
    kernel another path owns."""
    K.reset_launches()
    out = fn()
    launches = dict(K.LAUNCHES)
    check_launched(launches, what, kernels)
    return out, launches


def score_row(r):
    s = r["score"]
    return {k: s[k] for k in ("wall_s", "hot_hit_rate", "serve_p99_ms",
                              "bytes_per_round", "plan_cache_hit_rate")}


def phase_replay(at, K, dev):
    """Phase 15 (a)-(e); the traces and artifacts live under REPLAY_DIR
    and are removed after."""
    import shutil
    from adapm_tpu_torch.obs.decisions import load_dtrace
    from adapm_tpu_torch.obs.wtrace import WorkloadTrace, load_wtrace
    from adapm_tpu_torch.policy import train_policy
    from adapm_tpu_torch.replay import ReplayEngine, rank_candidates
    shutil.rmtree(REPLAY_DIR, ignore_errors=True)
    os.makedirs(REPLAY_DIR, exist_ok=True)
    t_phase = time.perf_counter()
    out = {}
    try:
        # (a) capture on the card, then the same workload uncaptured
        cap, out["launches_capture"] = replay_part(
            K, "phase 15 (a)", lambda: replay_workload(at, dev, True))
        off = replay_workload(at, dev, False)
        wpath = os.path.join(REPLAY_DIR, "run.wtrace")
        dpath = os.path.join(REPLAY_DIR, "run.dtrace")
        tr = load_wtrace(wpath)
        dtr = load_dtrace(dpath)
        kinds = tr.kinds()
        missing = [k for k in ("set", "intent", "pull", "push", "clock",
                               "serve", "sync", "quiesce", "reloc",
                               "promote") if not kinds.get(k)]
        check(not missing, f"phase 15 (a): event kinds missing from the "
              f"trace: {missing} ({kinds})")
        check(tr.dropped == 0 and cap["wtrace"]["dropped_total"] == 0,
              f"phase 15 (a): the capture dropped events "
              f"({cap['wtrace']['dropped_total']})")
        check(cap["wtrace"]["sampled_batches_total"] == 0,
              "phase 15 (a): key batches were sampled, not exact")
        planes = dtr.planes()
        check(all(planes.get(p, 0) > 0 for p in
                  ("reloc", "sync", "tier", "prefetch")),
              f"phase 15 (a): decisions by plane {planes}")
        key_events = sum(kinds.get(k, 0) for k in KEY_KINDS)
        out["capture"] = dict(
            kinds=kinds, key_events=key_events,
            wtrace_mib=os.path.getsize(wpath) / 2**20,
            dtrace_mib=os.path.getsize(dpath) / 2**20,
            planes=planes, dtrace_dropped=dtr.dropped,
            fill_s=cap["fill_s"], wall_s=cap["wall_s"],
            wall_s_off=off["wall_s"], fill_s_off=off["fill_s"],
            rounds=cap["rounds"], rounds_off=off["rounds"],
            record_ms=record_cost_ms(at))

        # (b) determinism on the card; the second replay runs under the
        # profiler (device time, busy share)
        def determinism():
            runs = {}
            for name, kw in (
                    ("seed11_a", {}), ("seed11_b", {}),
                    ("speed10", {"speed": 10.0}),
                    ("hot_half", {"overrides": {
                        "tier_hot_rows": TIER_HOT // 2}}),
                    ("seed12", {"seed": REPLAY_SEED + 1})):
                kw = {"seed": REPLAY_SEED, "speed": 100.0, **kw}
                eng = ReplayEngine(tr, device=dev, **kw)
                if name != "seed11_b" or str(dev) == "cpu":
                    runs[name] = eng.run()
                    continue
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    runs[name] = eng.run()
                dev_ms = sum(
                    e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
                out["replay_device_ms"] = dev_ms
                out["replay_busy"] = dev_ms / (runs[name]["wall_s"] * 1e3)
            return runs

        runs, out["launches_determinism"] = replay_part(
            K, "phase 15 (b)", determinism)
        a, b = runs["seed11_a"], runs["seed11_b"]
        check(a["reads"] > 0 and all(
            a[k] == b[k] for k in ("reads_digest", "reads",
                                   "events_replayed")),
              "phase 15 (b): two replays at speed 100 differ")
        for name in ("speed10", "hot_half"):
            check(runs[name]["reads_digest"] == a["reads_digest"],
                  f"phase 15 (b): the {name} replay's digest differs")
        check(runs["seed12"]["reads_digest"] != a["reads_digest"],
              "phase 15 (b): seed 12 replays to seed 11's digest")
        out["determinism"] = {
            n: dict(wall_s=r["wall_s"], digest=r["reads_digest"],
                    reads=r["reads"], events_replayed=r["events_replayed"],
                    score=score_row(r)) for n, r in runs.items()}
        out["synthesis"] = synthesis_ms(tr)

        # (c) a prefix of whole events on the card and on the cpu
        cut, seen = 0, 0
        for i, ev in enumerate(tr.events):
            seen += ev["kind"] in KEY_KINDS
            if seen == REPLAY_PREFIX:
                cut = i + 1
                break
        check(cut > 0, "phase 15 (c): the trace is shorter than the "
              "prefix")
        pre = WorkloadTrace(tr.path, tr.meta, tr.events[:cut], tr.dropped)
        rc, out["launches_prefix"] = replay_part(
            K, "phase 15 (c)", lambda: ReplayEngine(
                pre, seed=REPLAY_SEED, device=dev).run())
        rp = ReplayEngine(pre, seed=REPLAY_SEED, device="cpu").run()
        check(rc["reads"] > 0 and rc["reads_digest"] == rp["reads_digest"]
              and rc["reads"] == rp["reads"],
              "phase 15 (c): the card's replay of the prefix differs from "
              "the cpu's")
        out["prefix"] = dict(events=cut, key_events=REPLAY_PREFIX,
                             kinds=pre.kinds(), reads=rc["reads"],
                             wall_s=rc["wall_s"], wall_s_cpu=rp["wall_s"])

        # (d) training twice, then learned and shadow replays
        def policy():
            p1 = os.path.join(REPLAY_DIR, "policy1.json")
            p2 = os.path.join(REPLAY_DIR, "policy2.json")
            t0 = time.perf_counter()
            bundle = train_policy(dpath, wpath, out_path=p1)
            train_s = time.perf_counter() - t0
            train_policy(dpath, wpath, out_path=p2)
            with open(p1, "rb") as f1, open(p2, "rb") as f2:
                same = f1.read() == f2.read()
            check(same, "phase 15 (d): two trainings differ")
            learned = {"policy_file": p1, **{
                f"policy_{p}": "learned"
                for p in ("reloc", "tier", "sync", "serve")}}
            rl = ReplayEngine(tr, overrides=learned, seed=REPLAY_SEED,
                              score_decisions=True, device=dev).run(
                                  include_snapshot=True)
            rs = ReplayEngine(tr, overrides={"policy_file": p1,
                                             "policy_shadow": True},
                              seed=REPLAY_SEED, device=dev).run(
                                  include_snapshot=True)
            return bundle, train_s, os.path.getsize(p1), rl, rs

        (bundle, train_s, nbytes, rl, rs), out["launches_policy"] = \
            replay_part(K, "phase 15 (d)", policy)
        pol, dec = rl["snapshot"]["policy"], rl["snapshot"]["decision"]
        spol = rs["snapshot"]["policy"]
        for r, mode in ((rl, "learned"), (rs, "shadow")):
            check(r["reads_digest"] == a["reads_digest"],
                  f"phase 15 (d): the {mode} replay's digest differs "
                  f"from the plain replay's")
        for p in ("reloc", "tier", "sync"):
            check(pol[f"consults.{p}"] > 0 and spol[f"consults.{p}"] > 0,
                  f"phase 15 (d): the {p} plane had decisions and no "
                  f"consult (learned {pol[f'consults.{p}']}, shadow "
                  f"{spol[f'consults.{p}']})")
        check(dec.get("decided.serve", 0) == 0 or pol["consults.serve"] > 0,
              "phase 15 (d): serve decisions without a consult")
        check(spol["applied_total"] == 0,
              "phase 15 (d): shadow mode applied a verdict")
        out["policy"] = dict(
            train_s=train_s, artifact_bytes=nbytes,
            fit={p: m["fit"] for p, m in bundle.meta["train"].items()},
            rows={p: m["used"] for p, m in bundle.meta["train"].items()},
            learned_wall_s=rl["wall_s"], shadow_wall_s=rs["wall_s"],
            learned={k: pol[k] for k in pol if k.split(".")[0] in (
                "consults", "vetoes", "applied", "guard_blocked")},
            shadow_agree=spol["shadow_agree"],
            shadow_disagree=spol["shadow_disagree"],
            regret={p: dec.get(f"regret_rate.{p}")
                    for p in ("reloc", "tier", "sync", "serve")})

        # (e) ranking three candidates at speed 10
        cands = {"recorded": {},
                 "fewer_hot": {"tier_hot_rows": TIER_HOT // 4},
                 "half_rounds": {"channels": 8}}
        cpath = os.path.join(REPLAY_DIR, "compare.json")
        art, out["launches_rank"] = replay_part(
            K, "phase 15 (e)", lambda: rank_candidates(
                tr, cands, seed=REPLAY_SEED, speed=10.0, out_path=cpath,
                device=dev))
        with open(cpath) as fh:
            disk = json.load(fh)
        check(sorted(disk["ranking"]) == sorted(cands)
              and disk["winner"] == disk["ranking"][0] == art["winner"],
              f"phase 15 (e): the artifact is not ranked: "
              f"{disk.get('ranking')}")
        out["rank"] = dict(
            objective=art["objective"], ranking=art["ranking"],
            winner=art["winner"],
            candidates={n: dict(wall_s=c["wall_s"],
                                objective=c["score"][art["objective"]])
                        for n, c in art["candidates"].items()})
    finally:
        shutil.rmtree(REPLAY_DIR, ignore_errors=True)
    if str(dev) != "cpu":
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def report_replay(rr, smi):
    c = rr["capture"]
    print(f"phase 15 (a): [{smi}] capture on the card: {c['key_events']} "
          f"key-batch events, kinds {c['kinds']}; wtrace "
          f"{c['wtrace_mib']:.1f} MiB, dtrace {c['dtrace_mib']:.1f} MiB, "
          f"decisions by plane {c['planes']}; fill {c['fill_s']:.2f} s "
          f"(off {c['fill_s_off']:.2f} s), workload wall {c['wall_s']:.3f} s "
          f"captured, {c['wall_s_off']:.3f} s uncaptured (rounds "
          f"{c['rounds']} / {c['rounds_off']}); record_kv of a {B}-key "
          f"event {c['record_ms']:.3f} ms on the host; launches "
          f"{ {k: v for k, v in rr['launches_capture'].items() if v} }",
          flush=True)
    d = rr["determinism"]
    sy = rr["synthesis"]
    busy = (f"seed11_b profiled: device {rr['replay_device_ms']:.1f} ms, "
            f"busy {rr['replay_busy']:.4f}; " if "replay_busy" in rr else "")
    print(f"phase 15 (b): [{smi}] replays (seed {REPLAY_SEED}): "
          + "; ".join(f"{n} {r['wall_s']:.3f} s digest {r['digest'][:12]} "
                      f"reads {r['reads']} events {r['events_replayed']} "
                      f"score {r['score']}" for n, r in d.items())
          + f"; {busy}value synthesis {sy['ms_per_push']:.2f} ms a push "
          f"({sy['pushes']} pushes, {sy['sets']} sets); launches "
          f"{ {k: v for k, v in rr['launches_determinism'].items() if v} }",
          flush=True)
    p = rr["prefix"]
    print(f"phase 15 (c): prefix of {p['events']} events "
          f"({p['key_events']} key-batch events, kinds {p['kinds']}): "
          f"{p['reads']} reads, card digest == cpu digest; wall card "
          f"{p['wall_s']:.3f} s, cpu {p['wall_s_cpu']:.3f} s; launches "
          f"{ {k: v for k, v in rr['launches_prefix'].items() if v} }",
          flush=True)
    q = rr["policy"]
    print(f"phase 15 (d): [{smi}] training {q['train_s']:.3f} s, "
          f"{q['artifact_bytes']} B twice byte-identical, fit {q['fit']} "
          f"from rows {q['rows']}; learned replay {q['learned_wall_s']:.3f} s "
          f"digest == plain, {q['learned']}, regret {q['regret']}; shadow "
          f"replay {q['shadow_wall_s']:.3f} s digest == plain, agree "
          f"{q['shadow_agree']} disagree {q['shadow_disagree']}; launches "
          f"{ {k: v for k, v in rr['launches_policy'].items() if v} }",
          flush=True)
    k = rr["rank"]
    print(f"phase 15 (e): [{smi}] ranked by {k['objective']}: "
          f"{k['ranking']} (winner {k['winner']}); "
          + "; ".join(f"{n} {v['wall_s']:.3f} s {k['objective']} "
                      f"{v['objective']}" for n, v in k["candidates"].items())
          + f"; launches "
          f"{ {x: v for x, v in rr['launches_rank'].items() if v} }",
          flush=True)
    print(f"phase 15: {rr['wall_s']:.1f} s", flush=True)

# phase 16: the multi-process layer. (a) and (b): a loopback cluster of
# MP_NODES servers on the card in this process, one worker a node, on
# phase 3's key space; (c): the KGE app as MP_RANKS launched processes
# on the one card
# (a)'s rounds cut from 32 to 16: its pull/push percentiles are settled
# (PERF.md section 5), and the run has to stay within 80% of its limit
# (a)'s rounds cut from 32 to 16, then to 8 (4 + the 4 profiled) to fit
# the RESCAL lines: its latencies and keys/s are settled since PR 14
MP_NODES, MP_ROUNDS, MP_KEYS = 4, 8, 4096
MP_PROF_ROUNDS = 4   # (a)'s last rounds, profiled for the busy share: a
# trace of all 32 took ~60 s to post-process on the card's host
MP_STORM_ROUNDS = 8
MP_STORM_SPEC = "net.send=0.02,net.recv=0.02,net.dup=0.05,net.delay=0.02"
MP_STORM_TIMEOUT_S = 0.5                    # one attempt, in the storm
MP_RANKS = 2
# the ranks' records (removed), beside this script wherever it is run from
MP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      "phase16")
MP_APP_KERNELS = APP_KERNELS
MP_RANK_TIMEOUT_S = 420


def mp_cluster(at, dev):
    """MP_NODES loopback nodes on the card over phase 3's key space, each
    node's home keys filled from one seeded integer-valued table (so
    every fold is exact); returns the cluster and the NumPy shadow."""
    from adapm_tpu_torch.net import LoopbackCluster
    cl = LoopbackCluster(
        MP_NODES, num_keys=E + R, value_lengths=L, num_workers=1,
        device=dev, heartbeat_ms=100.0, timeout_ms=5000.0,
        opts_factory=lambda r: at.SystemOptions(sync_max_per_sec=0,
                                                prefetch=False))
    shadow = np.random.default_rng(16).integers(
        -4, 5, size=(E + R, L)).astype(np.float32)

    def fill(rank, srv):
        w = srv.make_worker(0)
        keys = np.arange(E + R, dtype=np.int64)
        mine = keys[srv.glob.home_proc(keys) == rank]
        for lo in range(0, len(mine), 50_000):
            k = mine[lo:lo + 50_000]
            w.wait(w.set(k, shadow[k]))
        srv.barrier()
        return w

    cl.workers = cl.run(fill)
    return cl, shadow


def mp_rounds(cl, shadow, rounds, seed, lat):
    """Each node's worker: per round, intent for its next batch of
    MP_KEYS zipf keys, a pull of this batch, a push of integer-valued
    rows to it, one planner round, advance_clock; then the quiesce
    protocol (WaitSync -> Barrier -> WaitSync -> Barrier). The pushes are
    drawn up front and added to the shadow. Returns the keys each node
    touched."""
    draws = []
    for rank in range(MP_NODES):
        rng = np.random.default_rng(seed + rank)
        ks = [np.unique(skewed_keys(rng, E, MP_KEYS))
              for _ in range(rounds + 1)]
        vs = [rng.integers(-2, 3, size=(len(k), L)).astype(np.float32)
              for k in ks[:rounds]]
        draws.append((ks, vs))
        for k, v in zip(ks, vs):
            shadow[k] += v

    def drive(rank, srv):
        w = cl.workers[rank]
        ks, vs = draws[rank]
        w.intent(ks[0], w.current_clock, w.current_clock)
        for i in range(rounds):
            w.intent(ks[i + 1], w.current_clock + 1, w.current_clock + 1)
            t0 = time.perf_counter()
            got = w.pull_sync(ks[i])
            t1 = time.perf_counter()
            w.wait(w.push(ks[i], vs[i]))
            t2 = time.perf_counter()
            lat["pull"].append(t1 - t0)
            lat["push"].append(t2 - t1)
            lat["keys"] += 2 * len(ks[i])
            check(np.isfinite(got).all(), "phase 16: non-finite pull")
            srv.drive_rounds(1)
            w.advance_clock()
        srv.wait_sync()
        srv.barrier()
        srv.wait_sync()
        srv.barrier()
        return np.unique(np.concatenate(ks[:rounds]))

    return cl.run(drive)


def mp_check_reads(cl, shadow, touched, what):
    """Every node reads every touched key: bitwise the shadow."""
    allk = np.unique(np.concatenate(touched))

    def read(rank, srv):
        return cl.workers[rank].pull_sync(allk)

    for rank, got in enumerate(cl.run(read)):
        check(got.tobytes() == shadow[allk].tobytes(),
              f"{what}: node {rank}'s reads of {len(allk)} keys differ "
              f"from the shadow")
    return len(allk)


def mp_stats(cl, ranks):
    pm = [cl.servers[r].glob.stats for r in ranks]
    net = [cl.servers[r].net.stats() for r in ranks]
    return dict(
        relocations=sum(p["relocations_in"] for p in pm),
        replications=sum(p["replicas_granted"] for p in pm),
        redirects=sum(p["redirects"] for p in pm),
        hops=[int(sum(cl.servers[r].glob.hops[i] for r in ranks))
              for i in range(3)],
        msgs=sum(n["msgs_out"] for n in net),
        bytes=sum(n["bytes_out"] for n in net),
        retransmits=sum(n["retransmits"] for n in net),
        dup_suppressed=sum(n["dup_suppressed"] for n in net),
        decode_errors=sum(n["decode_errors"] for n in net))


def p50_p99(xs):
    return (float(np.percentile(xs, 50)) * 1e3,
            float(np.percentile(xs, 99)) * 1e3)


def mp_loopback(at, K, dev):
    """Phase 16 (a) and (b)."""
    from torch.profiler import ProfilerActivity, profile
    from adapm_tpu_torch.base import CLOCK_MAX, NOT_CACHED
    from adapm_tpu_torch.fault.inject import FaultPlane
    out = {"parts_s": {}}
    mark = [time.perf_counter()]

    def lap(name):   # host seconds of each part, for the report
        now = time.perf_counter()
        out["parts_s"][name] = now - mark[0]
        mark[0] = now

    cl, shadow = mp_cluster(at, dev)
    lap("build and fill")
    dead = MP_NODES - 1
    try:
        # (a) the rounds; the last MP_PROF_ROUNDS profiled for the busy
        # share (each call ends in the quiesce protocol)
        lat = {"pull": [], "push": [], "keys": 0}
        K.reset_launches()
        t0 = time.perf_counter()
        touched = mp_rounds(cl, shadow, MP_ROUNDS - MP_PROF_ROUNDS, 1600,
                            lat)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            touched += mp_rounds(cl, shadow, MP_PROF_ROUNDS, 1650, lat)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        wall, prof_wall = t2 - t0, t2 - t1
        launches = dict(K.LAUNCHES)
        dev_s = sum(ev.self_device_time_total for ev in prof.key_averages()
                    if ev.device_type == torch.autograd.DeviceType.CUDA
                    ) / 1e6
        st = mp_stats(cl, range(MP_NODES))
        lap("(a) rounds")
        nread = mp_check_reads(cl, shadow, touched, "phase 16 (a)")
        lap("(a) reads")
        check(st["relocations"] > 0 and st["replications"] > 0,
              f"phase 16 (a): relocations {st['relocations']}, "
              f"replications {st['replications']}: both decisions must "
              f"occur")
        check(st["hops"][1] + st["hops"][2] > 0 and st["redirects"] > 0,
              f"phase 16 (a): no key was served after a redirect "
              f"(hops {st['hops']}, redirects {st['redirects']})")
        check(st["decode_errors"] == 0, "phase 16 (a): decode errors")
        check_launched(launches, "phase 16 (a)",
                       ("routed_gather", "ordered_scatter_add"))
        out["a"] = dict(st, wall_s=wall, keys_per_s=lat["keys"] / wall,
                        pull_ms=p50_p99(lat["pull"]),
                        push_ms=p50_p99(lat["push"]),
                        device_s=dev_s or None,
                        busy_share=dev_s / prof_wall if dev_s else None,
                        launches=launches, keys_read=nread)

        # (b) the storm: the wire points of every node's port fire
        planes = [FaultPlane(MP_STORM_SPEC, seed=5 + r)
                  for r in range(MP_NODES)]
        for node, fp in zip(cl.nodes, planes):
            node.port.fault = fp
        # a dropped frame costs one attempt's timeout before its
        # retransmit: shorter attempts for the storm
        timeout_s, cl.fabric.timeout_s = cl.fabric.timeout_s, \
            MP_STORM_TIMEOUT_S
        before = mp_stats(cl, range(MP_NODES))
        lat_b = {"pull": [], "push": [], "keys": 0}
        K.reset_launches()
        t0 = time.perf_counter()
        touched_b = mp_rounds(cl, shadow, MP_STORM_ROUNDS, 1700, lat_b)
        storm_s = time.perf_counter() - t0
        for node in cl.nodes:
            node.port.fault = None
        cl.fabric.timeout_s = timeout_s
        lap("(b) storm")
        fired = {p: sum(fp.counts(p)[1] for fp in planes)
                 for p in ("net.send", "net.recv", "net.dup", "net.delay")}
        check(sum(fired.values()) > 0, "phase 16 (b): no fault fired")
        nread_b = mp_check_reads(cl, shadow, touched_b, "phase 16 (b)")
        lap("(b) reads")
        st_b = mp_stats(cl, range(MP_NODES))
        check(st_b["decode_errors"] == 0, "phase 16 (b): decode errors")
        out["b"] = dict(fired=fired, wall_s=storm_s, keys_read=nread_b,
                        pull_ms=p50_p99(lat_b["pull"]),
                        retransmits=st_b["retransmits"]
                        - before["retransmits"],
                        dup_suppressed=st_b["dup_suppressed"]
                        - before["dup_suppressed"],
                        launches=dict(K.LAUNCHES))

        # (b) the dead-peer drill: the survivors replicate the hottest
        # keys (competing intents), then node `dead` is killed
        hot = np.unique(skewed_keys(np.random.default_rng(99), E, 2048))

        def replicate(rank, srv):
            w = cl.workers[rank]
            if rank != dead:
                w.intent(hot, w.current_clock, CLOCK_MAX)
            srv.wait_sync()
            srv.barrier()

        cl.run(replicate)
        lap("(b) replicate")
        survivors = [r for r in range(MP_NODES) if r != dead]
        expect = {}
        for r in survivors:
            srv = cl.servers[r]
            with srv._lock:
                keys = np.arange(srv.num_keys, dtype=np.int64)
                hint = srv.glob.owner_hint
                owned = (hint == dead) | ((hint == NOT_CACHED) &
                                          (srv.glob.home_proc(keys) == dead))
                cand = keys[owned & (srv.ab.owner < 0)]
                rep = (srv.ab.cache_slot[:, cand] >= 0).any(axis=0)
            expect[r] = (cand[rep], int((~rep).sum()))
        check(sum(len(v[0]) for v in expect.values()) > 0,
              "phase 16 (b): no survivor holds a replica of a key the "
              "dead node owns")
        t0 = time.perf_counter()
        cl.kill(dead)
        while time.perf_counter() - t0 < 30 and not all(
                cl.servers[r].net.stats()["failovers"] >= 1
                for r in survivors):
            time.sleep(0.01)
        drill = {}
        for r in survivors:
            ns = cl.servers[r].net.stats()
            check(ns["failovers"] == 1 and ns["peers_dead"] == 1,
                  f"phase 16 (b): node {r} did not fail over ({ns})")
            check(ns["promoted_keys"] == len(expect[r][0]),
                  f"phase 16 (b): node {r} promoted {ns['promoted_keys']}"
                  f" keys, {len(expect[r][0])} replicated")
            check(ns["lost_keys"] == expect[r][1],
                  f"phase 16 (b): node {r} counted {ns['lost_keys']} lost "
                  f"keys, {expect[r][1]} owned by the dead node without a "
                  f"replica")
            check(0.0 < ns["failover_s"] < 10.0,
                  f"phase 16 (b): failover_s {ns['failover_s']}")
            drill[r] = dict(promoted=ns["promoted_keys"],
                            lost=ns["lost_keys"],
                            failover_s=ns["failover_s"])
        detect_s = time.perf_counter() - t0

        def reread(rank, srv):
            k = expect[rank][0]
            got = cl.workers[rank].pull_sync(k)
            check(got.tobytes() == shadow[k].tobytes(),
                  f"phase 16 (b): node {rank}'s promoted keys differ from "
                  f"the shadow")
            return len(k)

        cl.run(reread, ranks=survivors)
        out["drill"] = dict(nodes=drill, detect_s=detect_s)
        lap("(b) drill")
    finally:
        cl.shutdown()
        dead_srv = cl.servers[dead]
        if dead_srv is not None and cl.fabric.is_dead(dead):
            dead_srv.shutdown()   # the corpse's own planes and pools
        del cl
        torch.cuda.empty_cache()
        lap("teardown")
    return out


def mp_rank(argv):
    """One launched rank of phase 16 (c): the KGE app (main's parse and
    run) on the card, its launch counts, the filtered counts of its evals
    (recorded where _rank_side_stats takes them) and its DCN traffic,
    written to OUT/rank<r>.json."""
    out = argv[argv.index("--mp-rank") + 1]
    app_argv = argv[argv.index("--") + 1:]
    from adapm_tpu_torch.apps import knowledge_graph_embeddings as kge
    from adapm_tpu_torch.ops import kernels as K
    from adapm_tpu_torch.parallel import control, pm
    counts, dcn = [], {}
    side = kge._rank_side_stats

    def record(greater):
        counts.append(np.asarray(greater).tolist())
        return side(greater)

    kge._rank_side_stats = record
    down = pm.GlobalPM.shutdown

    def shutdown(self):
        dcn.update(getattr(self.chan, "stats", {}))
        return down(self)

    pm.GlobalPM.shutdown = shutdown
    K.build()            # the parent built them: this finds the libraries
    K.reset_launches()
    res = kge.run_app(kge.build_parser().parse_args(app_argv))
    rank = control.process_id()
    keep = ("mrr", "hits1", "hits10", "mrr_o", "mrr_s", "test_mrr",
            "test_hits10", "epoch_s", "eval_s", "epoch_losses", "gen_s",
            "replicas_created", "loss")
    rec = {k: res[k] for k in keep}
    rec.update(rank=rank, launches=dict(K.LAUNCHES),
               replayed=dict(K.REPLAYED), counts=counts, dcn=dcn,
               cuda=torch.cuda.get_device_name(0))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(rec, fh)
    return 0


def mp_one_process(K, dev, argv, ckpt, recorded):
    """The one-process K4 eval of the table the ranks evaluated (rank 0's
    checkpoint): the filtered counts of the same triples and their
    near-tie counts (the plain version's), in the order the ranks
    recorded theirs."""
    from adapm_tpu_torch.apps import knowledge_graph_embeddings as kge
    from adapm_tpu_torch.io import kge as kgeio
    args = kge.build_parser().parse_args(argv + ["--init_from", ckpt])
    ds, _ = kgeio.generate_lowrank(
        num_entities=args.synthetic_entities,
        num_relations=args.synthetic_relations,
        n_train=args.synthetic_triples, seed=args.seed,
        dim_truth=args.gen_dim_truth, temperature=args.gen_temperature,
        torch_device=dev)
    run = kge.KgeRun(args, ds, device=dev)
    try:
        run.init_model()
        sr_o, ro_s = ds.filters()

        def emb_rows(keys, dim):
            return run.srv.read_main(keys).reshape(len(keys), -1)[:, :dim]

        got, ties = [], []
        for triples in (ds.valid[:args.eval_triples],
                        ds.test[:args.eval_triples]):
            for lo in range(0, len(triples), EVAL_B):
                t = triples[lo:lo + EVAL_B]
                s, r, o = t[:, 0], t[:, 1], t[:, 2]
                g_o, g_s, true_sc, t_o, t_s = kge._pool_counts(
                    run, s, r, o, ties=True)
                kge._filter_correct(run, emb_rows, s, r, o, g_o, g_s,
                                    true_sc, sr_o, ro_s)
                got += [g_o, g_s]
                ties += [t_o, t_s]
    finally:
        run.srv.shutdown()
    check(len(got) == len(recorded),
          f"phase 16 (c): the ranks recorded {len(recorded)} count "
          f"vectors, the one-process eval {len(got)}")
    diff = [np.abs(np.asarray(a) - b) for a, b in zip(recorded, got)]
    check(all((d <= t).all() for d, t in zip(diff, ties)),
          "phase 16 (c): the ranks' global counts differ from the "
          "one-process K4 eval of the same table beyond the near-tie rule")
    return dict(count_diff=int(max(d.max() for d in diff)),
                ties=int(sum(t.sum() for t in ties)),
                triples=int(sum(len(g) for g in got[::2])))


def mp_app(K, dev, script=None):
    """Phase 16 (c): the KGE app as MP_RANKS processes through the port's
    launcher, on the one card; each rank runs `script` (this file) with
    --mp-rank."""
    import shutil
    shutil.rmtree(MP_DIR, ignore_errors=True)
    os.makedirs(MP_DIR, exist_ok=True)
    argv = APP_ARGS + ["--synthetic_triples", str(100 * B), "--epochs",
                       "1", "--eval_every", "1", "--eval_triples", "100",
                       "--scan_steps", str(SCAN_K), "--checkpoint_every",
                       "1", "--checkpoint_dir", MP_DIR]
    log = os.path.join(MP_DIR, "ranks.log")
    env = dict(os.environ, TORCH_CPP_LOG_LEVEL="ERROR")
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        p = subprocess.Popen(
            [sys.executable, "-m", "adapm_tpu_torch.launcher", "-n",
             str(MP_RANKS), "--no-keepalive", "--", sys.executable,
             script or os.path.abspath(__file__), "--mp-rank", MP_DIR,
             "--"] + argv,
            stdout=fh, stderr=subprocess.STDOUT, env=env, cwd=here,
            start_new_session=True)
        try:
            code = p.wait(timeout=MP_RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            import signal
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
            code = "timeout"
    wall = time.perf_counter() - t0
    if code != 0:
        with open(log) as fh:
            tail = fh.read()[-6000:]
        raise RuntimeError(f"chip_smoke: phase 16 (c): the launched ranks "
                           f"failed ({code}):\n{tail}")
    ranks = []
    for r in range(MP_RANKS):
        with open(os.path.join(MP_DIR, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    stats = ("mrr", "hits1", "hits10", "mrr_o", "mrr_s", "test_mrr",
             "test_hits10")
    for rk in ranks[1:]:
        check(all(rk[k] == ranks[0][k] for k in stats),
              f"phase 16 (c): the ranks report different global eval "
              f"statistics: {[{k: x[k] for k in stats} for x in ranks]}")
        check(rk["counts"] == ranks[0]["counts"],
              "phase 16 (c): the ranks' global counts differ")
    for rk in ranks:
        ln, rp = rk["launches"], rk["replayed"]
        check_launched({k: ln[k] + rp[k] for k in ln},
                       f"phase 16 (c) rank {rk['rank']}", MP_APP_KERNELS)
        check(np.isfinite(rk["epoch_losses"]).all(),
              f"phase 16 (c): rank {rk['rank']}'s loss is not finite")
    t0 = time.perf_counter()
    one = mp_one_process(K, dev, argv,
                         os.path.join(MP_DIR, "kge_epoch0.npz"),
                         ranks[0]["counts"])
    one["s"] = time.perf_counter() - t0
    steps = [100 // MP_RANKS] * MP_RANKS
    eps = [n * B / rk["epoch_s"][0] for n, rk in zip(steps, ranks)]
    shutil.rmtree(MP_DIR, ignore_errors=True)
    return dict(wall_s=wall, examples_per_s=eps,
                examples_per_s_sum=float(sum(eps)),
                epoch_s=[rk["epoch_s"][0] for rk in ranks],
                eval_s=[rk["eval_s"] for rk in ranks],
                gen_s=[rk["gen_s"] for rk in ranks],
                mrr=ranks[0]["mrr"], test_mrr=ranks[0]["test_mrr"],
                loss=ranks[0]["loss"],
                replicas_created=[rk["replicas_created"] for rk in ranks],
                dcn=[rk["dcn"] for rk in ranks],
                launches=[rk["launches"] for rk in ranks],
                replayed=[rk["replayed"] for rk in ranks], one_process=one)


def phase_mp(at, K, dev):
    """Phase 16: (a) and (b) on the loopback cluster, (c) the launched
    app."""
    t0 = time.perf_counter()
    out = mp_loopback(at, K, dev)
    out["app"] = mp_app(K, dev)
    out["phase_s"] = time.perf_counter() - t0
    return out


def report_mp(mp, smi, app_eps=None):
    a, b, d, c = mp["a"], mp["b"], mp["drill"], mp["app"]
    print(f"phase 16 (a): {MP_NODES} loopback nodes on the card, "
          f"{MP_ROUNDS} rounds of {MP_KEYS} zipf keys a worker: pull "
          f"p50/p99 {a['pull_ms'][0]:.3f}/{a['pull_ms'][1]:.3f} ms, push "
          f"{a['push_ms'][0]:.3f}/{a['push_ms'][1]:.3f} ms, "
          f"{a['keys_per_s']:.0f} keys/s, relocations "
          f"{a['relocations']}, replications {a['replications']}, "
          f"redirects {a['redirects']}, hops(1/2/3+) {a['hops']}, net "
          f"{a['msgs']} msgs {a['bytes'] / 2**20:.1f} MiB, K1 "
          f"{a['launches']['routed_gather']} K3 "
          f"{a['launches']['ordered_scatter_add']}, busy "
          f"{a['busy_share']} (the last {MP_PROF_ROUNDS} rounds), "
          f"{a['keys_read']} keys read bitwise the "
          f"shadow on every node; host seconds by part "
          f"{ {k: round(v, 2) for k, v in mp['parts_s'].items()} } | "
          f"{smi}",
          flush=True)
    print(f"phase 16 (b): storm {MP_STORM_SPEC}: fired {b['fired']}, "
          f"retransmits {b['retransmits']}, duplicates suppressed "
          f"{b['dup_suppressed']}, {b['wall_s']:.2f} s for "
          f"{MP_STORM_ROUNDS} rounds, pull p50/p99 "
          f"{b['pull_ms'][0]:.3f}/{b['pull_ms'][1]:.3f} ms, "
          f"{b['keys_read']} keys bitwise; dead-peer drill: "
          f"{d['nodes']} (failed over within {d['detect_s']:.3f} s of "
          f"the kill)", flush=True)
    one = c["one_process"]
    beside = "" if app_eps is None else \
        f" (phase 5, one process: {app_eps:.0f})"
    print(f"phase 16 (c): the KGE app on {MP_RANKS} launched processes: "
          f"epochs {[round(t, 3) for t in c['epoch_s']]} s, examples/s "
          f"{[round(x) for x in c['examples_per_s']]}, summed "
          f"{c['examples_per_s_sum']:.0f}{beside}, evals "
          f"{c['eval_s']} s, loss (summed over the ranks, as the app's "
          f"allreduce reports it) {c['loss']:.6g}, MRR {c['mrr']:.4g} (test "
          f"{c['test_mrr']:.4g}) on every rank, equal to the one-process "
          f"K4 eval of the same table (count diff {one['count_diff']} "
          f"within {one['ties']} near-ties over {one['triples']} "
          f"triples x 2 sides; {one['s']:.1f} s), DCN {c['dcn']}, launches "
          f"{c['launches']} replayed {c['replayed']}, wall "
          f"{c['wall_s']:.1f} s; phase 16 {mp['phase_s']:.1f} s",
          flush=True)



# -- K13 and phases 17-18 ------------------------------------------------

COLL_RANKS, COLL_BUCKET, COLL_CADENCE = 3, 1024, 4
COLL_ROUNDS, COLL_KEYS = 16, 4096
COLL_KERNELS = ("routed_gather", "ordered_scatter_add", "alltoall_put")
# the ranks' records and checkpoint shards (removed), beside this script
COLL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "phase17")
COLL_RANK_TIMEOUT_S = 300
# segment B is long enough that the trailing window holds 100 or more
# freshness probes (every 8th push probes one key: about 6 a second at
# 1,500 events/s in batches of 32)
STREAM_SEGMENT_S, STREAM_SEGMENT_B_S = 2.0, 24.0
STREAM_CKPT_S, STREAM_TRAILING_S = 0.75, 20.0
FRESHNESS_MIN_SAMPLES = 100
STREAM_KERNELS = ("ordered_scatter_add", "gather_pool")
STREAM_DIR = os.path.join("build", "phase18")   # chain, trace (removed)


def k13_leaves(rng, P):
    """One rank's X1 leaves at phase 17's shapes: the keys [P, bucket]
    i64 (-1 padded past a random valid prefix) and the delta rows
    [P, bucket, L] f32 it sends each process."""
    keys = np.full((P, COLL_BUCKET), -1, dtype=np.int64)
    for d in range(P):
        n = int(rng.integers(COLL_BUCKET // 2, COLL_BUCKET + 1))
        keys[d, :n] = rng.integers(0, E + R, n)
    rows = rng.standard_normal((P, COLL_BUCKET, L)).astype(np.float32)
    return [keys, rows]


def phase_k13(K, dev, rng):
    """K13 in one process: P local raw-cudaMalloc slabs (a launch cannot
    tell a local slab pointer from an IPC-mapped one on the same card),
    each of P source ranks' packed X1 leaves put into every slab at both
    parities: bitwise the plain version (copy_ into torch tensors), and
    the slabs unpack to what each source sent. Timed as its device
    time in the trace with L2 flushed before each launch (the bound
    counts each byte read once from and written once to HBM; the 12.6
    MB of one put otherwise stays in the 50 MB L2 between launches) and
    with L2 warm, beside the plain version and P copy_ calls into the
    same slabs: the copies' Memcpy DtoD records in the trace, summed a
    call, L2 flushed and warm as K13's, and between CUDA events, as the
    wrapper call is."""
    from adapm_tpu_torch.parallel.exchange import _Layout
    P = COLL_RANKS
    sent = [k13_leaves(rng, P) for _ in range(P)]
    lay = _Layout(sent[0], P)
    T, nbytes = lay.T, 2 * P * lay.T
    ptrs = [K.slab_alloc(nbytes)[0] for _ in range(P)]
    try:
        slabs = [K.slab_view(p, nbytes) for p in ptrs]
        table = torch.tensor(ptrs, dtype=torch.int64, device=dev)
        plain = [torch.zeros(nbytes, dtype=torch.uint8, device=dev)
                 for _ in range(P)]
        srcs = [torch.from_numpy(lay.pack(x)).to(dev) for x in sent]
        for parity in (0, 1):
            for s in range(P):
                off = parity * P * T + s * T
                K.alltoall_put(srcs[s], slabs, off, table)
                K.alltoall_put_plain(srcs[s], plain, off)
        torch.cuda.synchronize()
        for d in range(P):
            check(torch.equal(slabs[d], plain[d]),
                  f"K13: slab {d} differs from the plain version")
            got = lay.unpack(slabs[d][:P * T].cpu().numpy().reshape(P, T))
            for s in range(P):
                check(all(np.array_equal(g[s], x[d])
                          for g, x in zip(got, sent[s])),
                      f"K13: slab {d} does not hold what rank {s} sent")
        put = lambda: K.alltoall_put(srcs[0], slabs, 0, table)  # noqa
        copies = lambda: [slabs[d][:T].copy_(srcs[0][d])  # noqa
                          for d in range(P)]
        warm, total = kernel_ms(put, "put_kernel")
        lib_warm, _ = kernel_ms(copies, "Memcpy", per_call=P)
        flush = torch.empty(64 << 20, device=dev)
        ms, _ = kernel_ms(put, "put_kernel", between=flush.zero_)
        lib_ms, _ = kernel_ms(copies, "Memcpy", per_call=P,
                              between=flush.zero_)
        del flush
        out = timed(
            max_abs_err=0.0, ms=ms, warm_ms=warm,
            plain_ms=cuda_ms(lambda: K.alltoall_put_plain(srcs[0], plain,
                                                          0)),
            library_ms=lib_ms, library_warm_ms=lib_warm,
            library_call_ms=cuda_ms(copies),
            bound=bound(2 * P * T, 0),
            call_ms=cuda_ms(lambda: K.alltoall_put(srcs[0], slabs, 0,
                                                   table)),
            device_ms_per_call=total, bytes_per_put=P * T,
            ptxas=ptxas_summary("alltoall_put"))
    finally:
        torch.cuda.synchronize()
        del slabs, plain
        for p in ptrs:
            K.slab_free(p)
    return out


def report_k13(r):
    print(f"phase 2: K13 alltoall_put, {COLL_RANKS} destinations x "
          f"{r['bytes_per_put'] // COLL_RANKS} bytes (bucket {COLL_BUCKET}"
          f": keys i64 + rows of {L} f32): kernel, L2 flushed before "
          f"each launch, {fmt_t(r, 'ms')} ms in the trace (bound "
          f"{r['bound'][0]:.4f} ms, {r['bound'][1]}, share "
          f"{r['bound'][0] / r['ms']:.3f}), L2-warm "
          f"{fmt_s(*r['warm_ms'])} ms; the wrapper call "
          f"between events {fmt_s(*r['call_ms'])} ms; plain "
          f"{fmt_t(r, 'plain_ms')} ms; {COLL_RANKS} copy_ into the same "
          f"slabs, their Memcpy DtoD records in the trace summed a call, "
          f"L2 flushed {fmt_t(r, 'library_ms')} ms, L2-warm "
          f"{fmt_s(*r['library_warm_ms'])} ms, between events "
          f"{fmt_s(*r['library_call_ms'])} ms; bitwise the plain version "
          f"at both parities; ptxas {r['ptxas']}", flush=True)


def coll_exchange_plain(K, rank, P):
    """One exchange of phase 17's X1 leaves straight through the rank's
    engine (`coll.exchange`, K13 on the card), and what the plain put
    (K13's plain version over CPU slabs) delivers to this rank from the
    same P sources' leaves: (got, want)."""
    from adapm_tpu_torch.parallel.exchange import _Layout
    sent = [k13_leaves(np.random.default_rng(1700 + s), P)
            for s in range(P)]
    lay = _Layout(sent[0], P)
    slabs = [torch.zeros(P * lay.T, dtype=torch.uint8) for _ in range(P)]
    for s_ in range(P):
        K.alltoall_put_plain(torch.from_numpy(lay.pack(sent[s_])), slabs,
                             s_ * lay.T)
    want = lay.unpack(slabs[rank].numpy().reshape(P, lay.T))
    return sent[rank], want


def coll_shadow():
    """Phase 17's integer-valued table, from one seed (phase 16's)."""
    return np.random.default_rng(16).integers(
        -4, 5, size=(E + R, L)).astype(np.float32)


def coll_draws(rank, seed=170):
    """Rank `rank`'s round keys (COLL_ROUNDS + 1 batches of COLL_KEYS zipf
    keys) and integer pushes, then its collective pull keys and
    collective push rows."""
    rng = np.random.default_rng(seed + rank)
    ks = [np.unique(skewed_keys(rng, E, COLL_KEYS))
          for _ in range(COLL_ROUNDS + 1)]
    vs = [rng.integers(-2, 3, size=(len(k), L)).astype(np.float32)
          for k in ks[:COLL_ROUNDS]]
    ck = np.unique(rng.integers(0, E + R, COLL_KEYS)).astype(np.int64)
    cv = rng.integers(-2, 3, size=(len(ck), L)).astype(np.float32)
    return ks, vs, ck, cv


def coll_rank(argv):
    """One launched rank of phase 17: `--coll-rank OUT train` fills its
    home keys, drives the collective path and saves its checkpoint
    shard; `--coll-rank OUT restore` restores that shard into a fresh
    server and reads back. Writes OUT/<stage><rank>.json."""
    out, stage = argv[argv.index("--coll-rank") + 1:][:2]
    import adapm_tpu_torch as at
    from adapm_tpu_torch.ops import kernels as K
    from adapm_tpu_torch.parallel import control
    from adapm_tpu_torch.utils.checkpoint import restore_server, save_server
    parts = {}
    t0 = time.perf_counter()
    K.build()            # the parent built them: this finds the libraries
    rank, P = control.process_id(), control.num_processes()
    srv = at.setup(E + R, L, opts=at.SystemOptions(
        sync_max_per_sec=0, prefetch=False, collective_sync=True,
        collective_bucket=COLL_BUCKET, collective_cadence=COLL_CADENCE))
    w = srv.make_worker(0)
    shadow = coll_shadow()
    draws = [coll_draws(r) for r in range(P)]
    for ks, vs, ck, cv in draws:
        for k, v in zip(ks, vs):
            shadow[k] += v
    touched = np.unique(np.concatenate(
        [np.concatenate(d[0][:COLL_ROUNDS]) for d in draws]))
    ckpt = os.path.join(out, "ck")
    rec = dict(rank=rank, cuda=torch.cuda.get_device_name(0),
               device=str(srv.ctx.device),
               current=torch.cuda.current_device())
    parts["setup_s"] = time.perf_counter() - t0
    if stage == "restore":
        for ks, vs, ck, cv in draws:
            shadow[ck] += cv
        t0 = time.perf_counter()
        restore_server(srv, ckpt)
        rec["restore_s"] = time.perf_counter() - t0
        allk = np.union1d(touched, np.concatenate([d[2] for d in draws]))
        got = w.pull_sync(allk)
        rec["restored_bitwise"] = got.tobytes() == shadow[allk].tobytes()
        rec["keys_read"] = int(len(allk))
        srv.barrier()
        srv.shutdown()
        rec["parts_s"] = parts
        with open(os.path.join(out, f"restore{rank}.json"), "w") as fh:
            json.dump(rec, fh)
        return 0
    keys = np.arange(E + R, dtype=np.int64)
    t0 = time.perf_counter()
    mine = keys[srv.glob.home_proc(keys) == rank]
    base = coll_shadow()
    for lo in range(0, len(mine), 50_000):
        k = mine[lo:lo + 50_000]
        w.wait(w.set(k, base[k]))
    del base
    srv.barrier()
    parts["fill_s"] = time.perf_counter() - t0
    ks, vs, ck, cv = draws[rank]
    lat = []
    K.reset_launches()
    t0 = time.perf_counter()
    w.intent(ks[0], w.current_clock, w.current_clock)
    for i in range(COLL_ROUNDS):
        w.intent(ks[i + 1], w.current_clock + 1, w.current_clock + 1)
        got = w.pull_sync(ks[i])
        check(np.isfinite(got).all(), "phase 17: non-finite pull")
        w.wait(w.push(ks[i], vs[i]))
        t1 = time.perf_counter()
        srv.drive_rounds(1)
        lat.append(time.perf_counter() - t1)
        w.advance_clock()
    srv.wait_sync()
    srv.barrier()
    srv.wait_sync()
    srv.barrier()
    torch.cuda.synchronize()
    parts["rounds_s"] = time.perf_counter() - t0
    rec["launches"] = dict(K.LAUNCHES)
    rec["round_s"] = lat
    t0 = time.perf_counter()
    got = w.pull_sync(touched)
    rec["reads_bitwise"] = got.tobytes() == shadow[touched].tobytes()
    rec["keys_read"] = int(len(touched))
    srv.barrier()          # RPC reads done before the next exchange
    parts["check_s"] = time.perf_counter() - t0
    coll = srv.glob.coll
    rec["stats"] = dict(coll.stats)
    rec["pm"] = {k: int(v) for k, v in srv.glob.stats.items()}
    rec["bytes_put"] = coll.bytes_put
    rec["replicas_created"] = int(srv.sync.stats.replicas_created)
    snap = srv.metrics_snapshot()["collective"]
    rec["exchange_s"] = snap["exchange_s"]
    # the collective pull and push of COLL_KEYS keys
    t0 = time.perf_counter()
    c0 = srv.collective_pull(ck).reshape(len(ck), L)
    rec["coll_pull_bitwise"] = c0.tobytes() == shadow[ck].tobytes()
    srv.collective_push(ck, cv)
    for _, _, ck2, cv2 in draws:
        shadow[ck2] += cv2
    srv.barrier()
    c1 = srv.collective_pull(ck).reshape(len(ck), L)
    rec["coll_push_bitwise"] = c1.tobytes() == shadow[ck].tobytes()
    torch.cuda.synchronize()
    parts["coll_pull_push_s"] = time.perf_counter() - t0
    rec["launches_all"] = dict(K.LAUNCHES)
    # the cross-process exchange itself against its plain version
    mine, want = coll_exchange_plain(K, rank, P)
    got = coll.exchange(tuple(mine))
    rec["exchange_bitwise"] = all(
        g.tobytes() == x.tobytes() for g, x in zip(got, want))
    t0 = time.perf_counter()
    save_server(srv, ckpt)
    rec["save_s"] = time.perf_counter() - t0
    rec["shard_bytes"] = os.path.getsize(f"{ckpt}.rank{rank}.npz")
    srv.shutdown()
    rec["parts_s"] = parts
    with open(os.path.join(out, f"train{rank}.json"), "w") as fh:
        json.dump(rec, fh)
    return 0


def coll_launch(stage, script=None):
    """COLL_RANKS processes of this script through the port's launcher,
    on the one card."""
    log = os.path.join(COLL_DIR, f"{stage}.log")
    env = dict(os.environ, TORCH_CPP_LOG_LEVEL="ERROR")
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        p = subprocess.Popen(
            [sys.executable, "-m", "adapm_tpu_torch.launcher", "-n",
             str(COLL_RANKS), "--no-keepalive", "--", sys.executable,
             script or os.path.abspath(__file__), "--coll-rank", COLL_DIR,
             stage],
            stdout=fh, stderr=subprocess.STDOUT, env=env, cwd=here,
            start_new_session=True)
        try:
            code = p.wait(timeout=COLL_RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            import signal
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
            code = "timeout"
    wall = time.perf_counter() - t0
    if code != 0:
        with open(log) as fh:
            tail = fh.read()[-6000:]
        raise RuntimeError(f"chip_smoke: phase 17 ({stage}): the launched "
                           f"ranks failed ({code}):\n{tail}")
    recs = []
    for r in range(COLL_RANKS):
        with open(os.path.join(COLL_DIR, f"{stage}{r}.json")) as fh:
            recs.append(json.load(fh))
    return recs, wall


def phase_collective(K, dev, script=None):
    """Phase 17: the collective path as COLL_RANKS launched processes,
    then the per-rank restore into COLL_RANKS fresh ones."""
    import shutil
    shutil.rmtree(COLL_DIR, ignore_errors=True)
    os.makedirs(COLL_DIR, exist_ok=True)
    t_phase = time.perf_counter()
    train, wall_t = coll_launch("train", script)
    restore, wall_r = coll_launch("restore", script)
    cards = torch.cuda.device_count()
    for rk in train + restore:
        # each rank on its own card where there are enough, and that
        # card current (the kernel wrappers launch on its stream)
        own = rk["rank"] % cards
        check(rk["device"] == f"cuda:{own}" and rk["current"] == own,
              f"phase 17 rank {rk['rank']}: pools on {rk['device']}, "
              f"current device {rk['current']}, expected cuda:{own}")
    for rk in train:
        what = f"phase 17 rank {rk['rank']}"
        check(rk["reads_bitwise"], f"{what}: reads of {rk['keys_read']} "
              "touched keys differ from the shadow")
        st = rk["stats"]
        check(st["iterations"] > 0 and st["rows_out"] > 0 and
              st["rows_in"] > 0, f"{what}: the exchange moved nothing: "
              f"{st}")
        check(rk["replicas_created"] > 0, f"{what}: no replica was made")
        check(rk["coll_pull_bitwise"] and rk["coll_push_bitwise"],
              f"{what}: collective pull/push differ from the shadow")
        check(rk["exchange_bitwise"], f"{what}: an exchange of phase 17's "
              "leaves differs from its plain version's delivery")
        check_launched(rk["launches"], what, COLL_KERNELS)
        check_launched(rk["launches_all"], what + " (collective pull/push)",
                       COLL_KERNELS)
    for rk in restore:
        check(rk["restored_bitwise"], f"phase 17 rank {rk['rank']}: the "
              "restored shard's reads differ from the shadow")
    shutil.rmtree(COLL_DIR, ignore_errors=True)
    from adapm_tpu_torch.obs.metrics import hist_percentile
    xs = [rk["exchange_s"] for rk in train]
    rounds = np.concatenate([rk["round_s"] for rk in train])
    it = sum(rk["stats"]["iterations"] for rk in train) / len(train)
    return dict(
        train=train, restore=restore, wall_s=(wall_t, wall_r),
        exchange_ms=[(hist_percentile(x, 0.5) * 1e3,
                      hist_percentile(x, 0.99) * 1e3) for x in xs],
        exchanges=[x["count"] for x in xs],
        iterations=[rk["stats"]["iterations"] for rk in train],
        rounds=[rk["stats"]["rounds"] for rk in train],
        iterations_per_round=it / max(1, train[0]["stats"]["rounds"]),
        rows_out=[rk["stats"]["rows_out"] for rk in train],
        rows_in=[rk["stats"]["rows_in"] for rk in train],
        bytes_put=[rk["bytes_put"] for rk in train],
        round_ms=p50_p99(rounds),
        save_s=[rk["save_s"] for rk in train],
        restore_s=[rk["restore_s"] for rk in restore],
        shard_mib=[rk["shard_bytes"] / 2**20 for rk in train],
        parts_s=[rk["parts_s"] for rk in train],
        launches=[rk["launches"] for rk in train],
        devices=[rk["device"] for rk in train],
        phase_s=time.perf_counter() - t_phase)


def report_collective(c, smi):
    print(f"phase 17: {COLL_RANKS} launched ranks on {c['devices']}, "
          f"--sys.collective_sync bucket {COLL_BUCKET} cadence "
          f"{COLL_CADENCE}, {COLL_ROUNDS} rounds of {COLL_KEYS} zipf "
          f"keys a rank: exchange p50/p99 per rank "
          f"{[(round(a, 3), round(b, 3)) for a, b in c['exchange_ms']]} "
          f"ms over {c['exchanges']} exchanges; BSP rounds {c['rounds']}, "
          f"iterations {c['iterations']} ({c['iterations_per_round']:.2f} "
          f"a round), rows out {c['rows_out']} in {c['rows_in']}, bytes "
          f"put {[round(b / 2**20, 1) for b in c['bytes_put']]} MiB; "
          f"planner round p50/p99 {c['round_ms'][0]:.3f}/"
          f"{c['round_ms'][1]:.3f} ms; reads of every touched key and the "
          f"collective pull/push of {COLL_KEYS} keys bitwise the shadow on "
          f"every rank, an exchange of K13's phase-2 leaves bitwise its "
          f"plain version's delivery; launches {c['launches']} | {smi}",
          flush=True)
    print(f"phase 17: per-rank save {[round(s, 3) for s in c['save_s']]} "
          f"s ({[round(m, 1) for m in c['shard_mib']]} MiB shards), restore "
          f"into {COLL_RANKS} fresh ranks "
          f"{[round(s, 3) for s in c['restore_s']]} s, bitwise; host "
          f"seconds by part {c['parts_s']}; launches wall "
          f"{[round(s, 1) for s in c['wall_s']]} s; phase 17 "
          f"{c['phase_s']:.1f} s", flush=True)


def phase_stream(at, K, dev):
    """Phase 18: run_northstar on the card at phase 3's width; the table
    right after replay_tail against an unkilled shadow that applied the
    same batches; the captured .wtrace replayed twice."""
    import shutil
    from adapm_tpu_torch.obs.wtrace import load_wtrace
    from adapm_tpu_torch.replay import ReplayEngine
    from adapm_tpu_torch.stream import EventLog, StreamTrainer
    from adapm_tpu_torch.stream.scenario import _build, _opts, run_northstar
    shutil.rmtree(STREAM_DIR, ignore_errors=True)
    os.makedirs(STREAM_DIR, exist_ok=True)
    t_phase = time.perf_counter()
    allk = np.arange(E + R, dtype=np.int64)
    held = {}

    def on_replayed(srv):
        held["table"] = srv.read_main(allk)
        held["cursor"] = int(srv.stream.cursor[0])

    K.reset_launches()
    res = run_northstar(
        num_keys=E + R, vlen=L, segment_s=STREAM_SEGMENT_S,
        segment_b_s=STREAM_SEGMENT_B_S,
        ckpt_every_s=STREAM_CKPT_S, trailing_s=STREAM_TRAILING_S,
        workdir=STREAM_DIR, device=dev, on_replayed=on_replayed)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check_launched(launches, "phase 18", STREAM_KERNELS)
    d = res["drill"]
    check(d["restored_cursor"] < d["acked_at_kill"],
          f"phase 18: the restored cursor {d['restored_cursor']} does not "
          f"lag the acked watermark {d['acked_at_kill']}")
    check(held["cursor"] == d["acked_at_kill"], "phase 18: replay_tail "
          "did not reach the acked watermark")
    # the unkilled shadow: the same initial table, the same batches
    t0 = time.perf_counter()
    hot = np.arange(512, dtype=np.int64)
    shadow, _, _ = _build(E + R, L, _opts(32, 0.0, 0.0, None), hot, dev)
    try:
        tr = StreamTrainer(shadow, EventLog(E + R, seed=7,
                                            keys_per_event=8))
        tr.run_until(d["acked_at_kill"])
        want = shadow.read_main(allk)
    finally:
        shadow.shutdown()
    check(held["table"].tobytes() == want.tobytes(),
          "phase 18: the restored and replayed table differs from the "
          "unkilled shadow")
    shadow_s = time.perf_counter() - t0
    del held["table"], want
    t0 = time.perf_counter()
    path = os.path.join(STREAM_DIR, "northstar.wtrace")
    tr = load_wtrace(path)
    digests = [ReplayEngine(tr, seed=11, device=dev).run()["reads_digest"]
               for _ in range(2)]
    check(digests[0] == digests[1], f"phase 18: the .wtrace replays to "
          f"two digests {digests}")
    replay_s = time.perf_counter() - t0
    shutil.rmtree(STREAM_DIR, ignore_errors=True)
    return dict(res=res, launches=launches, shadow_s=shadow_s,
                replay_s=replay_s, digest=digests[0],
                trace_events=len(tr.events),
                phase_s=time.perf_counter() - t_phase)


def report_stream(s, smi):
    r, d = s["res"], s["res"]["drill"]
    f = r["freshness"]
    if f["samples"] >= FRESHNESS_MIN_SAMPLES:
        fresh = f"freshness p50/p99 {f['p50_ms']}/{f['p99_ms']} ms"
    else:
        fresh = (f"freshness p50/p99 not reported (fewer than "
                 f"{FRESHNESS_MIN_SAMPLES} samples)")
    parts = {seg: {k: round(v, 3) if isinstance(v, float) else v
                   for k, v in p.items()}
             for seg, p in r["ingest"].items()}
    print(f"phase 18: run_northstar on the card, {E + R} keys of {L} f32, "
          f"stream batch {r['stream_batch']} at {r['stream_rate']} "
          f"events/s, segment A {STREAM_SEGMENT_S} s, segment B "
          f"{STREAM_SEGMENT_B_S} s: {r['events_per_sec']} events/s "
          f"({r['events_applied']} applied); the ingest pump's host "
          f"seconds by part {parts}; served p50/p99 {r['served_p50_ms']}/"
          f"{r['served_p99_ms']} ms over {r['served_lookups']} gold bag "
          f"reads ({r['bronze_sheds']} bronze sheds), {fresh} (target "
          f"{f['target_ms']} ms, {f['samples']} samples in the trailing "
          f"{f['trailing_window_s']} s; all of segment B "
          f"{f['segment_b_samples']} samples, p99 "
          f"{f['segment_b_p99_ms']} ms), "
          f"recovery_s {d['recovery_s']} (restored cursor "
          f"{d['restored_cursor']} behind the acked {d['acked_at_kill']}, "
          f"{d['replayed_events']} replayed); the replayed table bitwise "
          f"an unkilled shadow ({s['shadow_s']:.1f} s); the .wtrace "
          f"({s['trace_events']} events) replays to one digest twice "
          f"({s['replay_s']:.1f} s); launches {s['launches']}; phase 18 "
          f"{s['phase_s']:.1f} s | {smi}", flush=True)


# phase 19: the north-star runs (adapm_tpu_torch/northstar.py) through
# their entry points at full size: a Wikidata5M-sized ComplEx table
# (4,600,822 keys of 512 f32), 1B-words-sized SGNS (1,600,000 keys of 256
# f32) and MovieLens-25M-sized MF (221,588 keys of 256 f32). Each run's
# kernel set; keys pulled for the bitwise check; eval queries checked
# against K4's plain version; steps and eval calls profiled after each
# timing; the element past which a flat f32 offset leaves 32 bits
NS_KERNELS = {"kge": APP_KERNELS, "w2v": W2V_KERNELS, "mf": MF_KERNELS}
NS_SAMPLE, NS_EVAL_QUERIES, NS_PROFILED = 4096, 8, 4
NS_PAST = 2**31
NS_KGE = dict(E=4_600_000, R=822, d=D_MODEL)   # run_kge's own defaults


def ns_pull_check(srv, touched, rng):
    """NS_SAMPLE of the run's touched keys (half of them, where there
    are so many, with a slot past element NS_PAST of the pool) pulled
    through Worker.pull, bitwise a direct read of the pool at their
    address-book coordinates. Returns (keys pulled, keys past)."""
    st, ab = srv.stores[0], srv.ab
    _, M, width = st.main.shape
    flat = (ab.owner[touched].astype(np.int64) * M + ab.slot[touched]) * width
    past = touched[flat >= NS_PAST]
    pick = rng.choice(past, min(len(past), NS_SAMPLE // 2), replace=False)
    rest = np.setdiff1d(touched, pick)
    keys = np.concatenate([pick, rng.choice(
        rest, min(len(rest), NS_SAMPLE - len(pick)), replace=False)])
    keys = rng.permutation(keys)
    got = srv.workers()[0].pull_sync(keys)
    sh = torch.as_tensor(ab.owner[keys].astype(np.int64), device=st.main.device)
    sl = torch.as_tensor(ab.slot[keys].astype(np.int64), device=st.main.device)
    direct = st.main[sh, sl].cpu().numpy()
    check(got.shape == direct.shape and np.array_equal(
        got.view(np.uint32), direct.view(np.uint32)), "phase 19: a pull of "
          "touched keys differs from the pool at their coordinates")
    return len(keys), len(pick)


def ns_kge_checks(K, ns, E, R, d, srv, touched, rng):
    """Phase 19 (kge) on the live server after its run: the pull check;
    the eval counts of NS_EVAL_QUERIES queries over every entity against
    K4's plain version under the near-tie rule; then K1 and K3 over
    NS_SAMPLE coordinates of the top rows of the pool (from a little
    below element NS_PAST to its last row, duplicates, out-of-range and
    negative slots among them) bitwise their plain versions. K3 runs
    last: it writes into the pool, which shuts down right after."""
    out = {}
    out["pulled"], out["pulled_past"] = ns_pull_check(srv, touched, rng)
    main = srv.stores[0].main
    dev = main.device
    fn, tables, ent_keys = ns.eval_program(srv, E, d)
    ent = touched[touched < E]
    q = [torch.as_tensor(k, device=dev) for k in (
        rng.choice(ent, NS_EVAL_QUERIES), rng.integers(E, E + R,
                                                       NS_EVAL_QUERIES),
        rng.choice(ent, NS_EVAL_QUERIES))]
    g_o, g_s, _ = fn(main, tables, ent_keys, E, *q)
    p_o, p_s, _, t_o, t_s = fn(main, tables, ent_keys, E, *q, ties=True)
    diff = (torch.cat([g_o, g_s]) - torch.cat([p_o, p_s])).abs()
    ties = torch.cat([t_o, t_s])
    check(bool((diff <= ties).all()), f"phase 19: eval counts over {E} "
          f"candidates break the near-tie rule: diff {diff.tolist()} ties "
          f"{ties.tolist()}")
    out["eval_diff"], out["eval_ties"] = int(diff.sum()), int(ties.sum())
    S_, M, width = main.shape
    lo = NS_PAST // width - NS_SAMPLE // 2
    sl = rng.integers(lo, M, NS_SAMPLE)
    sl[1::4] = sl[0::4]                      # targets named twice and more
    sl[::97] = M
    sl[1::101] = -1
    sh = torch.zeros(NS_SAMPLE, dtype=torch.int32, device=dev)
    sl = torch.as_tensor(sl.astype(np.int32), device=dev)
    got = K.routed_gather(main, None, None, sh, sl)
    want = K.routed_gather_plain(main, None, None, sh, sl)
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          "phase 19: K1 on rows past element 2^31 differs from its plain "
          "version")
    vals = torch.randn(NS_SAMPLE, width, device=dev)
    ref = main.clone()
    K.ordered_scatter_add_plain(ref, sh, sl, vals)
    K.ordered_scatter_add(main, sh, sl, vals)
    check(torch.equal(main.view(torch.int32), ref.view(torch.int32)),
          "phase 19: K3 on rows past element 2^31 differs from its plain "
          "version")
    del ref
    out["rows_past"] = int(((sl.long() * width) >= NS_PAST).sum())
    return out


NS_TRACED = ("routed_gather", "ordered_fold", "complex_step", "sgns_step",
             "mf_step", "pool_eval_counts")


def ns_profile(step, steps):
    """device_breakdown of NS_PROFILED more calls of a step slope_time
    timed, taken again (up to four times) where the trace lost records:
    every call runs the same device work, so each of the port's kernels,
    and all the records together, come a whole number of times a call
    (a trace late in the full run once held 22.5 records a step). Where
    all five lost records, the last is returned marked `lost`, and the
    report calls its device time not measured."""
    for _ in range(5):
        prof = device_breakdown(lambda i: step(steps + i), NS_PROFILED)
        if prof is None:
            return None
        ours = [c for k, c in prof["counts"].items()
                if any(n in k for n in NS_TRACED)]
        total = round(prof["device_ops_per_step"] * NS_PROFILED)
        if ours and total % NS_PROFILED == 0 and \
                all(c % NS_PROFILED == 0 for c in ours):
            return prof
        TRACE_RETAKES["phase 19"] = TRACE_RETAKES.get("phase 19", 0) + 1
    return dict(prof, lost=True)


def ns_run(at, K, ns, name, run, checks):
    """One north-star run through its entry point, watched: the launches
    and peak memory up to its server's shutdown, where `checks(srv,
    touched, rng)` runs on the live server; each slope timing followed by
    NS_PROFILED more calls of its step under the profiler; the losses of
    every step call; the host seconds of the training thread's parts.
    Launches are set to 0 just before the run and read at its shutdown,
    before the checks launch anything."""
    from adapm_tpu_torch.core.kv import Worker
    from adapm_tpu_torch.core.sync import SyncManager
    from adapm_tpu_torch.ops.fused import DeviceRoutedRunner, DeviceRouter
    rec = {"profiles": [], "losses": [], "touched": []}
    slope, shutdown = ns.slope_time, at.Server.shutdown
    call, intent = DeviceRoutedRunner.__call__, Worker.intent

    def profiled_slope(step, steps):
        dt = slope(step, steps)
        rec["profiles"].append(ns_profile(step, steps))
        return dt

    def recorded_call(self, *a, **kw):
        loss = call(self, *a, **kw)
        rec["losses"].append(loss.detach().reshape(1))
        return loss

    def recorded_intent(self, keys, *a, **kw):
        if len(rec["touched"]) < 8:
            rec["touched"].append(np.asarray(keys, dtype=np.int64))
        return intent(self, keys, *a, **kw)

    def checked_shutdown(srv):
        if "launches" in rec:
            return shutdown(srv)
        torch.cuda.synchronize()
        rec["launches"] = dict(K.LAUNCHES)
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rec["table_gib"] = sum(st.main.numel() * 4
                               for st in srv.stores) / 2**30
        rec["keys"], rec["width"] = srv.num_keys, srv.stores[0].main.shape[2]
        try:
            rec["checks"] = checks(srv, np.unique(np.concatenate(
                rec["touched"])), np.random.default_rng(19))
        finally:
            shutdown(srv)

    clock = HostClock([(Worker, "intent", "intent"),
                       (DeviceRoutedRunner, "__call__", "step call"),
                       (SyncManager, "run_round", "run_round"),
                       (DeviceRouter, "refresh", "mirror refresh")])
    t0 = time.perf_counter()
    ns.slope_time, at.Server.shutdown = profiled_slope, checked_shutdown
    DeviceRoutedRunner.__call__, Worker.intent = recorded_call, \
        recorded_intent
    # the last run's server and runner hold each other: collect them, so
    # this run's peak is its own
    gc.collect()
    torch.cuda.empty_cache()
    try:
        with clock:
            torch.cuda.reset_peak_memory_stats()
            K.reset_launches()
            res = run()
    finally:
        ns.slope_time, at.Server.shutdown = slope, shutdown
        DeviceRoutedRunner.__call__, Worker.intent = call, intent
    check("checks" in rec, f"phase 19 ({name}): the run's server never "
          "shut down")
    check_launched(rec["launches"], f"phase 19 ({name})", NS_KERNELS[name])
    losses = torch.cat(rec["losses"])
    check(len(losses) > 0 and bool(torch.isfinite(losses).all()),
          f"phase 19 ({name}): a non-finite loss")
    rec.update(res=res, steps=len(losses), run_s=time.perf_counter() - t0,
               host_ms={k: (1e3 * float(np.median(v)) if v else 0.0,
                            1e3 * sum(v), len(v))
                        for k, v in clock.calls.items()})
    del rec["losses"], rec["touched"]
    return rec


def phase_northstar(at, K):
    """Phase 19: python -m adapm_tpu_torch.northstar's kge --eval, w2v
    and mf on the card at their full sizes, each through its run_*
    entry point (ns_run)."""
    from adapm_tpu_torch import northstar as ns
    t_phase = time.perf_counter()

    def pulled(srv, touched, rng):
        out = {}
        out["pulled"], out["pulled_past"] = ns_pull_check(srv, touched, rng)
        return out

    out = {"kge": ns_run(at, K, ns, "kge", lambda: ns.run_kge(
        do_eval=True, **NS_KGE), lambda *a: ns_kge_checks(
            K, ns, *NS_KGE.values(), *a)),
           "w2v": ns_run(at, K, ns, "w2v", ns.run_w2v, pulled),
           "mf": ns_run(at, K, ns, "mf", ns.run_mf, pulled)}
    check(out["kge"]["checks"]["pulled_past"] > 0 and
          out["kge"]["checks"]["rows_past"] > 0, "phase 19 (kge): no key "
          "or row past element 2^31 checked")
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def report_northstar(ns_rec, smi):
    for name in ("kge", "w2v", "mf"):
        r = ns_rec[name]
        print(json.dumps(r["res"]), flush=True)
        profs = r["profiles"]
        step = profs[0]
        dev = "device time not measured (the profiler recorded none)" \
            if step is None else (
                "device time not measured (5 traces lost records)"
                if step.get("lost") else
                f"device {step['device_ms_per_step']:.3f} ms/step in "
                f"{step['device_ops_per_step']:.1f} operations, busy "
                f"{step['busy_share']:.3f} of {step['wall_ms_per_step']:.3f} "
                f"ms/step profiled; top: " + "; ".join(
                    f"{k} {v:.3f}" for k, v in step["top_ms_per_step"][:6]))
        evals = "".join(
            f"; eval B={b} device {p['device_ms_per_step']:.3f} ms/batch, "
            f"busy {p['busy_share']:.3f}, top: " + "; ".join(
                f"{k} {v:.3f}" for k, v in p["top_ms_per_step"][:3])
            for b, p in zip((64, 512), profs[1:])
            if p is not None and not p.get("lost"))
        host = ", ".join(f"{k} {ms:.3f} ({n} calls, {tot:.1f} in all)"
                         for k, (ms, tot, n) in r["host_ms"].items())
        c = r["checks"]
        extra = "" if name != "kge" else (
            f"; eval of {NS_EVAL_QUERIES} queries over every entity within "
            f"the near-tie rule (diff {c['eval_diff']}, ties "
            f"{c['eval_ties']}); K1 and K3 over {NS_SAMPLE} coordinates "
            f"({c['rows_past']} past element 2^31) bitwise their plain "
            f"versions")
        print(f"phase 19 ({name}): {r['keys']:,} keys of {r['width']} f32, "
              f"main pool {r['table_gib']:.2f} GiB on the card; {dev}"
              f"{evals}; peak {r['peak_gib']:.2f} GiB; launches "
              f"{ {k: v for k, v in r['launches'].items() if v} }; host ms "
              f"a call (median): {host}; {r['steps']} step calls, losses "
              f"finite; a pull of {c['pulled']} touched keys "
              f"({c['pulled_past']} past element 2^31) bitwise the pool"
              f"{extra}; {r['run_s']:.1f} s | {smi}", flush=True)
    print(f"phase 19: {ns_rec['phase_s']:.1f} s", flush=True)


def drive_path(K, path, kernels, seed):
    """Phase 3 or 7: the path's main path (counts set to 0 just before,
    read just after) and its run_scan windows, reported and checked."""
    K.reset_launches()
    mp = phase_main_path(K, path, seed)
    launches = dict(K.LAUNCHES)
    report_main_path(mp, launches, path)
    check_launched(launches, path.phase, kernels)
    sc = phase_scan(K, path, seed + 1)
    report_scan(sc, path)
    check_launched(sc["launches"], f"{path.phase} (run_scan)", kernels)
    check(sc["captures"] == 1, f"{path.phase}: run_scan captured "
          f"{sc['captures']} graphs for one signature and one placement")
    return mp, launches, sc


def main(argv):
    t_start = time.perf_counter()
    json_path = argv[argv.index("--json") + 1] if "--json" in argv else None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    if "--mp-rank" in argv:
        # one launched rank of phase 16 (c), started by this script
        return mp_rank(argv)
    if "--coll-rank" in argv:
        # one launched rank of phase 17, started by this script
        return coll_rank(argv)
    import adapm_tpu_torch as at
    from adapm_tpu_torch.ops import kernels as K
    watch_background(at)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(f"card: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)
    build_s = K.build()
    print(f"phase 1: kernels built in {build_s:.1f} s", flush=True)
    # the port's lint over its own tree (python -m adapm_tpu_torch.lint)
    from adapm_tpu_torch.lint import Analyzer
    t_lint = time.perf_counter()
    lint = Analyzer(os.path.dirname(os.path.dirname(
        os.path.abspath(at.__file__)))).run()
    check(lint.ok(), "phase 1: the port's lint found:\n" + lint.to_text())
    print(f"phase 1: lint clean over {lint.files_scanned} files, "
          f"{len(lint.rules)} rules, {len(lint.suppressions_used)} "
          f"justified suppressions, in "
          f"{time.perf_counter() - t_lint:.2f} s", flush=True)
    rng = np.random.default_rng(0)
    if "--kernels" in argv:
        # the named kernels' phase-2 checks and times alone, unchecked
        # against the contract's other phases: copied into an earlier
        # tree of the port, it times that tree's kernels the same way
        parts = {"K1": (phase_k1_alone, report_k1_alone),
                 "K4": (phase_k4, report_k4), "K8": (phase_k8, report_k8),
                 "K4mp": (phase_k4_mp, report_k4_mp),
                 "K13": (phase_k13, report_k13),
                 "K16": (phase_k16, report_k16),
                 "K17": (phase_k17, report_k17),
                 "K3": (lambda K, dev, rng: phase_k3(
                     K, dev, *step_keys(dev, rng)), report_k3),
                 "K14": (phase_k14, lambda r: report_k14_k15(
                     {"drop_set": r})),
                 "K15": (phase_k15, lambda r: report_k14_k15(
                     {"sync_round": r}))}
        for nm, key, run in (("K9", "gather_cold", phase_k9),
                             ("K10", "gather_pool_cold", phase_k10),
                             ("K11", "write_main_rows", phase_k11),
                             ("K12", "sync_compress", phase_k12)):
            parts[nm] = (run, lambda r, key=key: report_tier_kernels(
                {key: r}, (key,)))
        names = argv[argv.index("--kernels") + 1].split(",")
        check(names and all(nm in parts for nm in names),
              f"--kernels takes a comma-separated list of {sorted(parts)}")
        for nm in names:
            run, report = parts[nm]
            report(run(K, dev, rng))
        return 0
    kge_path = StepPath("phase 3", lambda seed: kge_server(at, dev, seed),
                        kge_batches, 0.1, B, "triples", STEP_LAUNCHES,
                        "complex_step_kernel")
    rescal_path = StepPath("phase 3 (RESCAL)",
                           lambda seed: rescal_server(at, dev, seed),
                           kge_batches, 0.1, B, "triples",
                           RESCAL_STEP_LAUNCHES, "rescal_step_kernel")
    w2v_path = StepPath("phase 7", lambda seed: w2v_server(at, dev, seed),
                        w2v_batches, W2V_LR, B_W2V, "pairs",
                        W2V_STEP_LAUNCHES, "sgns_step_kernel")
    if "--main-path-only" in argv:
        # phase 3 alone, unchecked: runs against an earlier tree of the
        # port too (copy the script there), for a like-with-like compare
        K.reset_launches()
        report_main_path(phase_main_path(K, kge_path, 0), dict(K.LAUNCHES),
                         kge_path)
        return 0
    if "--rescal-only" in argv:
        # phase 3 (RESCAL) alone, checked as in the full run: copied into
        # an earlier tree, it drives that tree's RESCAL step the same way
        drive_path(K, rescal_path, RESCAL_STEP_KERNELS, 5)
        return 0
    if "--fault-only" in argv:
        # phase 14 alone (checkpoint chains, fault injection, flight
        # tracing, the reporter), checked as in the full run
        report_fault(phase_fault(at, K, dev), smi)
        check(not BACKGROUND_FAULTS, f"background work failed: "
              f"{BACKGROUND_FAULTS}")
        print(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s",
              flush=True)
        return 0
    if "--replay-only" in argv:
        # phase 15 alone (workload traces, decision telemetry, replay,
        # the learned policy), checked as in the full run
        report_replay(phase_replay(at, K, dev), smi)
        check(not BACKGROUND_FAULTS, f"background work failed: "
              f"{BACKGROUND_FAULTS}")
        print(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s",
              flush=True)
        return 0
    if "--mp-only" in argv:
        # phase 16 alone (the multi-process layer), checked as in the
        # full run
        report_mp(phase_mp(at, K, dev), smi)
        check(not BACKGROUND_FAULTS, f"background work failed: "
              f"{BACKGROUND_FAULTS}")
        print(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s",
              flush=True)
        return 0
    if "--collective-only" in argv:
        # phase 17 alone (the collective exchange, per-rank
        # checkpoints), checked as in the full run
        report_collective(phase_collective(K, dev), smi)
        print(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s",
              flush=True)
        return 0
    if "--stream-only" in argv:
        # phase 18 alone (the streaming plane), checked as in the full run
        report_stream(phase_stream(at, K, dev), smi)
        check(not BACKGROUND_FAULTS, f"background work failed: "
              f"{BACKGROUND_FAULTS}")
        print(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s",
              flush=True)
        return 0
    if "--northstar-only" in argv:
        # phase 19 alone (the north-star runs at full size), checked as
        # in the full run
        report_northstar(phase_northstar(at, K), smi)
        check(not BACKGROUND_FAULTS, f"background work failed: "
              f"{BACKGROUND_FAULTS}")
        print(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s",
              flush=True)
        return 0
    if "--pipeline-only" in argv:
        # the prefetch pipeline's and the background planner's phases
        # alone (3 on and off, 11, 12), checked as in the full run
        report_pipeline(phase_pipeline(at, K, dev), smi)
        report_pull_flow(phase_pull_flow(at, K, dev), smi)
        report_planner(phase_planner(at, K, dev), smi)
        check(not BACKGROUND_FAULTS, f"background work failed: "
              f"{BACKGROUND_FAULTS}")
        return 0
    # where the run's time goes: the seconds since the start at the end
    # of each phase, printed and kept in the --json record
    laps = []

    def lap(what):
        laps.append((what, round(time.perf_counter() - t_start, 1)))
        print(f"chip_smoke: {what} done at {laps[-1][1]} s", flush=True)

    lap("phase 1")
    rec = phase_kernels(K, dev, rng)
    report_kernels(rec)
    lap("phase 2")
    mp, step_launches, sc = drive_path(K, kge_path, STEP_KERNELS, 0)
    lap("phase 3")
    rmp, rescal_step_launches, rsc = drive_path(K, rescal_path,
                                                RESCAL_STEP_KERNELS, 5)
    lap("phase 3 (RESCAL)")
    pp = phase_pipeline(at, K, dev)
    report_pipeline(pp, smi)
    lap("phase 3 (pipeline)")
    used = phase_replicas(at, K, dev)
    print(f"phase 4: replica phase launches {used} (per replica step "
          f"{REPLICA_STEP_LAUNCHES}); cuda and cpu agree", flush=True)
    lap("phase 4")
    pf = phase_pull_flow(at, K, dev)
    report_pull_flow(pf, smi)
    lap("phase 11")
    pl = phase_planner(at, K, dev)
    report_planner(pl, smi)
    lap("phase 12")
    app, app_launches = phase_app(K)
    tps = [100 * B / t for t in app["epoch_s"]]
    print(f"phase 5: app: generation {app['gen_s']:.2f} s, epochs "
          f"{[round(t, 3) for t in app['epoch_s']]} s "
          f"({[round(x) for x in tps]} triples/s), evals "
          f"{[round(t, 3) for t in app['eval_s']]} s, scan_steps {SCAN_K}, "
          f"losses "
          f"{app['epoch_losses']}, MRR {app['mrr']:.4g} (o "
          f"{app['mrr_o']:.4g}, s {app['mrr_s']:.4g}), test MRR "
          f"{app['test_mrr']:.4g}, ceiling {app['truth_mrr']:.4f}, launches "
          f"{app_launches}, replayed {app['replayed']}, peak "
          f"{app['peak_mem_gib']:.2f} GiB", flush=True)
    print("phase 5: host seconds inside: " + "; ".join(
        f"{k} {v:.3f}" for k, v in app["host_seconds"].items()), flush=True)
    report_app_pipeline(app, smi)
    lap("phase 5")
    hr = phase_host_routes(K)
    f = hr["full"]
    print(f"phase 6: host routes: generation {f['gen_s']:.2f} s, epoch "
          f"{f['epoch_s'][0]:.3f} s ({10 * B / f['epoch_s'][0]:.0f} "
          f"triples/s), eval {[round(t, 3) for t in f['eval_s']]} s, loss "
          f"{f['epoch_losses']}, MRR {f['mrr']:.4g}, launches "
          f"{hr['full_launches']}; small config losses cuda "
          f"{hr['small_losses_cuda']} vs cpu {hr['small_losses_cpu']}, MRR "
          f"{hr['small_mrr_cuda']:.4f} vs {hr['small_mrr_cpu']:.4f}, count "
          f"diff {hr['count_diff']} within {hr['ties']} near-ties; RESCAL "
          f"losses cuda {hr['rescal_losses_cuda']} vs cpu "
          f"{hr['rescal_losses_cpu']}, launches {hr['rescal_launches']}; "
          f"RESCAL on device routes (--scan_steps 2): losses "
          f"{hr['rescal_dev_losses']}, launches {hr['rescal_dev_launches']}"
          f", replayed {hr['rescal_dev_replayed']}; "
          f"shared [N] negatives (autograd + K2): losses "
          f"{[round(x, 5) for x in hr['shared_negatives']['losses']]}, "
          f"launches {hr['shared_negatives']['launches']}", flush=True)
    lap("phase 6")
    st, w2v_step_launches, sc7 = drive_path(K, w2v_path, W2V_KERNELS, 2)
    lap("phase 7")
    w2v_app = phase_w2v_app(K)
    report_w2v_app(w2v_app)
    lap("phase 8")
    mfr = phase_mf_app(K)
    report_mf(mfr)
    lap("phase 9")
    serve_flat = phase_serve_flat(at, K, dev)
    serve_bags = phase_serve_bags(at, K, dev)
    report_serve(serve_flat, serve_bags, smi)
    lap("phase 10")
    tier_app = phase_tier_app(K)
    report_tier_app(tier_app, smi)
    lap("phase 13 (a)")
    storm = phase_tier_storm(at, K, dev)
    report_tier_storm(storm, smi)
    lap("phase 13 (b)")
    tier_bags = phase_tier_bags(at, K, dev, serve_bags["segments"]["sum"])
    report_tier_bags(tier_bags, smi)
    lap("phase 13 (c)")
    tier_pl = phase_tier_planner(at, K, dev, {
        k: pl[k] for k in ("bytes_shipped", "bytes_full_equiv",
                           "bytes_per_round", "rounds_s")})
    report_tier_planner(tier_pl, smi)
    epi = phase_episodic(at, K, dev)
    report_episodic(epi, smi)
    lap("phase 13 (d, e)")
    fr = phase_fault(at, K, dev)
    report_fault(fr, smi)
    lap("phase 14")
    rr = phase_replay(at, K, dev)
    report_replay(rr, smi)
    lap("phase 15")
    mpr = phase_mp(at, K, dev)
    report_mp(mpr, smi, app_eps=tps[-1])
    lap("phase 16")
    cr = phase_collective(K, dev)
    report_collective(cr, smi)
    lap("phase 17")
    sr = phase_stream(at, K, dev)
    report_stream(sr, smi)
    lap("phase 18")
    nsr = phase_northstar(at, K)
    report_northstar(nsr, smi)
    lap("phase 19")
    sources = {"routed_gather": ("adapm_tpu_torch/csrc/routed_gather.cu",
                                 "adapm_tpu/ops/pallas_kernels.py:36"),
               "adagrad_update": ("adapm_tpu_torch/csrc/adagrad.cu",
                                  "adapm_tpu/ops/pallas_kernels.py:76"),
               "ordered_scatter_add": ("adapm_tpu_torch/csrc/"
                                       "ordered_scatter.cu",
                                       "adapm_tpu/device/jaxport.py:95"),
               "pool_eval_counts": ("adapm_tpu_torch/csrc/"
                                    "pool_eval_counts.cu",
                                    "adapm_tpu/models/kge.py:238"),
               "complex_step": ("adapm_tpu_torch/csrc/complex_step.cu",
                                "adapm_tpu/ops/fused.py:370"),
               "sgns_step": ("adapm_tpu_torch/csrc/sgns_step.cu",
                             "adapm_tpu/ops/fused.py:370"),
               "mf_step": ("adapm_tpu_torch/csrc/mf_step.cu",
                           "adapm_tpu/ops/fused.py:370"),
               "gather_pool": ("adapm_tpu_torch/csrc/gather_pool.cu",
                               "adapm_tpu/device/jaxport.py:79"),
               "gather_cold": ("adapm_tpu_torch/csrc/gather_cold.cu",
                               "adapm_tpu/device/jaxport.py:256"),
               "gather_pool_cold": ("adapm_tpu_torch/csrc/gather_pool.cu",
                                    "adapm_tpu/device/jaxport.py:269"),
               "write_main_rows": ("adapm_tpu_torch/csrc/"
                                   "write_main_rows.cu",
                                   "adapm_tpu/device/jaxport.py:368"),
               "sync_compress": ("adapm_tpu_torch/csrc/sync_compress.cu",
                                 "adapm_tpu/device/jaxport.py:140"),
               "alltoall_put": ("adapm_tpu_torch/csrc/alltoall_put.cu",
                                "adapm_tpu/device/jaxport.py:654"),
               "drop_set": ("adapm_tpu_torch/csrc/drop_set.cu",
                            "adapm_tpu/device/jaxport.py:104"),
               "sync_round": ("adapm_tpu_torch/csrc/sync_round.cu",
                              "adapm_tpu/device/jaxport.py:126"),
               "rescal_step": ("adapm_tpu_torch/csrc/rescal_step.cu",
                               "adapm_tpu/ops/fused.py:370"),
               # K17 has no TPU original
               "pool_eval_dist": ("adapm_tpu_torch/csrc/pool_eval_dist.cu",
                                  None)}
    paths = dict(step=step_launches, scan=sc["launches"],
                 scan_replayed=sc["replayed"], replica=used,
                 app=app_launches, app_replayed=app["replayed"],
                 host_routes=hr["full_launches"],
                 rescal_step=rescal_step_launches,
                 rescal_scan=rsc["launches"],
                 rescal_scan_replayed=rsc["replayed"],
                 rescal=hr["rescal_launches"],
                 rescal_app_device=hr["rescal_dev_launches"],
                 rescal_app_device_replayed=hr["rescal_dev_replayed"],
                 shared_negatives=hr["shared_negatives"]["launches"],
                 w2v_step=w2v_step_launches, w2v_scan=sc7["launches"],
                 w2v_scan_replayed=sc7["replayed"],
                 w2v_app=w2v_app["launches"],
                 w2v_app_replayed=w2v_app["app"]["replayed"],
                 w2v_host_routes=w2v_app["host_launches"],
                 mf_app=mfr["device"]["launches"],
                 mf_app_replayed=mfr["device"]["res"]["replayed"],
                 mf_host_routes=mfr["host"]["launches"],
                 serve_flat=serve_flat["seg1"]["launches"],
                 serve_flat_replica=serve_flat["seg2"]["launches"],
                 serve_bags=serve_bags["launches"],
                 pipeline_step=pp["launches_on"],
                 pull_flow=pf["launches_on"],
                 pull_flow_staging={k: pf["staging_k1"] if
                                    k == "routed_gather" else 0
                                    for k in K.LAUNCHES},
                 planner=pl["launches"],
                 tier_app=tier_app["int8"]["launches"],
                 tier_app_replayed=tier_app["int8"]["replayed"],
                 tier_app_fp32=tier_app["fp32"]["launches"],
                 tier_storm=storm["fp32"]["launches"],
                 tier_storm_int8=storm["int8"]["launches"],
                 tier_bags=tier_bags["launches"],
                 tier_planner=tier_pl["int8"]["launches"],
                 tier_planner_fp16=tier_pl["fp16"]["launches"],
                 episodic=epi["episodic"]["launches"],
                 fault_chain=fr["chain"]["launches"],
                 fault_degraded=fr["degraded"]["launches"],
                 fault_tiered=fr["tiered"]["launches"],
                 flight_serve=fr["flight"]["traced"]["launches"],
                 replay_capture=rr["launches_capture"],
                 replay_determinism=rr["launches_determinism"],
                 replay_prefix=rr["launches_prefix"],
                 replay_policy=rr["launches_policy"],
                 replay_rank=rr["launches_rank"],
                 mp_loopback=mpr["a"]["launches"],
                 mp_storm=mpr["b"]["launches"],
                 mp_app=mpr["app"]["launches"][0],
                 mp_app_rank1=mpr["app"]["launches"][1],
                 mp_app_replayed=mpr["app"]["replayed"][0],
                 collective=cr["launches"][0],
                 collective_rank1=cr["launches"][1],
                 collective_rank2=cr["launches"][2],
                 stream=sr["launches"],
                 northstar_kge=nsr["kge"]["launches"],
                 northstar_w2v=nsr["w2v"]["launches"],
                 northstar_mf=nsr["mf"]["launches"],
                 rotate_eval=rec["pool_eval_dist"]["path"]["launches"],
                 rotate_app=rec["pool_eval_dist"]["path"]["app_launches"])
    # `launches`: the wrappers' count in the app run (phase 5) for the
    # ComplEx path's kernels, in phase 3 (RESCAL)'s main path for K16,
    # in phase 6's run with shared [N] negatives for K2, whose
    # standalone launches it keeps, in the word2vec and MF app runs
    # (phases 8 and 9, device routes) for K6 and K7, in phase 10's bag
    # segments for K8, in phase 13's tiered int8 app run (a) for K9 and
    # K11, its tiered bag segment (c) for K10 and its int8 compressed
    # planner run (d) for K12, in phase 17's rank 0 for K13, in phase
    # 12's planner run for K14 and K15, in phase 2's RotatE eval
    # program for K17; the
    # launches of replayed graphs stand apart under *_replayed
    home = {"adagrad_update": "shared_negatives",
            "rescal_step": "rescal_step", "sgns_step": "w2v_app",
            "mf_step": "mf_app", "gather_pool": "serve_bags",
            "gather_cold": "tier_app", "gather_pool_cold": "tier_bags",
            "write_main_rows": "tier_app", "sync_compress": "tier_planner",
            "alltoall_put": "collective", "drop_set": "planner",
            "sync_round": "planner", "pool_eval_dist": "rotate_eval"}
    kernels = [dict(name=n, route="cuda", source=sources[n][0],
                    replaces=sources[n][1],
                    launches=paths[home.get(n, "app")][n],
                    launches_by_path={p: v.get(n, 0)
                                      for p, v in paths.items()},
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                    bound_by=r["bound"][1], library_ms=r["library_ms"])
               for n, r in rec.items()]
    # K4's multi-process form (phase 2 at one rank's owned candidates,
    # launched on phase 16 (c)'s ranks) on K4's line
    k4m = rec["pool_eval_counts"]["mp_form"]
    kernels[list(rec).index("pool_eval_counts")].update(
        mp_form_replaces="adapm_tpu/models/kge.py:175",
        mp_form_launches=paths["mp_app"]["pool_eval_counts"],
        mp_form_max_abs_err=k4m["max_abs_err"], mp_form_ms=k4m["ms"],
        mp_form_entry_ms=k4m["entry_ms"], mp_form_plain_ms=k4m["plain_ms"],
        mp_form_bound_ms=k4m["bound"][0], mp_form_bound_by=k4m["bound"][1],
        mp_form_library_ms=k4m["library_ms"])
    # the parent's eager path (K5-K7, K16), K6-K8's views, K13's L2-warm
    # and event times and its copy_ calls'
    for line in kernels:
        for key in ("eager_ms", "cold_ms", "call_ms", "event_ms",
                    "warm_ms", "library_warm_ms", "library_call_ms"):
            if key in rec[line["name"]]:
                line[key] = rec[line["name"]][key][0]
    # K14's other forms and the JAX programs it also replaces; K15's
    # thresholded round, its device records a round against the parent's
    k14 = rec["drop_set"]
    kernels[list(rec).index("drop_set")].update(
        replaces_also=[f"adapm_tpu/device/jaxport.py:{n}" for n in
                       (114, 214, 224, 237, 283, 290, 300)],
        **{f"{form}_ms": k14["forms"][form]["ms"]
           for form in ("install", "install_src", "zero")},
        **{f"{form}_bound_ms": k14["forms"][form]["bound"][0]
           for form in ("install", "install_src", "zero")},
        duplicates_ms=k14["duplicates"]["ms"])
    k15 = rec["sync_round"]
    kernels[list(rec).index("sync_round")].update(
        replaces_also=["adapm_tpu/device/jaxport.py:188"],
        parent_ms=k15["parent_ms"][0], held_ms=k15["held"]["ms"],
        held_bound_ms=k15["held"]["bound"][0],
        held_parent_ms=k15["held"]["parent_ms"][0],
        launches_a_round=k15["launches_a_round"],
        parent_launches_a_round=k15["parent_launches_a_round"],
        held_launches_a_round=k15["held"]["launches_a_round"],
        heavy_ms=k15["heavy"][0.0]["ms"],
        heavy_held_ms=k15["heavy"][0.5]["ms"])
    # K1 and K3 at the relation rows' width (phase 2's K16 part)
    wide = rec["rescal_step"]["wide"]
    k1 = rec["routed_gather"]
    kernels[list(rec).index("routed_gather")].update(
        kernel_ms=k1["kernel_ms"][0],
        library_kernel_ms=k1["library_kernel_ms"], slab_f32=k1["slab_f32"],
        rows_32768_ms=wide["k1_ms"][0],
        rows_32768_kernel_ms=wide["k1_kernel_ms"][0],
        rows_32768_bound_ms=wide["k1_bound"][0],
        rows_32768_library_ms=wide["k1_library_ms"][0],
        rows_32768_library_kernel_ms=wide["k1_library_kernel_ms"],
        rows_32768_slab_f32=wide["k1_slab"],
        rows_32768_fill_kernel_ms=wide["k1_fill_kernel_ms"],
        rows_32768_one_row_kernel_ms=wide["k1_one_row_kernel_ms"][0],
        rows_32768_full_kernel_ms=wide["k1_full_kernel_ms"][0],
        rows_32768_full_bound_ms=wide["k1_full_bound"][0],
        rows_32766_kernel_ms=wide["k1_f32_kernel_ms"][0])
    kernels[list(rec).index("rescal_step")].update(
        eager_peak_gib=rec["rescal_step"]["eager_peak_gib"])
    k3 = rec["ordered_scatter_add"]
    k3_line = kernels[list(rec).index("ordered_scatter_add")]
    k3_line.update(fold_ms=k3["fold_ms"][0], order_ms=k3["order_ms"][0],
                   sort_ms=k3["sort_ms"][0], uniform_ms=k3["uniform_ms"][0],
                   rows_32768_ms=wide["k3_ms"][0],
                   rows_32768_fold_ms=wide["k3_fold_ms"][0],
                   rows_32768_bound_ms=wide["k3_bound"][0],
                   rows_32768_library_ms=wide["k3_library_ms"][0])
    full = rec["gather_pool"]["full_batch"]   # K8 at a 64-request batch
    kernels[list(rec).index("gather_pool")].update(
        full_batch_ms=full["ms"], full_batch_bound_ms=full["bound"][0],
        full_batch_plain_ms=full["plain_ms"],
        full_batch_library_ms=full["library_ms"],
        equal_ms=rec["gather_pool"]["equal_ms"][0],
        full_batch_equal_ms=full["equal_ms"][0])
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)),
                    exist_ok=True)
        with open(json_path, "w") as fh:
            json.dump({"card": smi, "kernels": kernels, "timings": rec,
                       "main_path": mp, "scan": sc,
                       "rescal_main_path": rmp, "rescal_scan": rsc,
                       "replica_launches": used,
                       "app": app, "host_routes": hr, "build_s": build_s,
                       "w2v_step": st, "w2v_scan": sc7, "w2v_app": w2v_app,
                       "mf_app": mfr, "serve_flat": serve_flat,
                       "serve_bags": serve_bags, "pipeline": pp,
                       "pull_flow": pf, "planner": pl, "tier_app": tier_app,
                       "tier_storm": storm, "tier_bags": tier_bags,
                       "tier_planner": tier_pl, "episodic": epi,
                       "fault": fr, "replay": rr, "mp": mpr,
                       "collective": cr, "stream": sr, "northstar": nsr,
                       "laps": laps}, fh,
                      indent=1,
                      default=str)
    check(not BACKGROUND_FAULTS, f"background work failed: "
          f"{BACKGROUND_FAULTS}")
    print(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s; "
          f"profiler traces retaken {TRACE_RETAKES}", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
