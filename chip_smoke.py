"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout; takes no arguments and needs one card.
Phases, each of which stops the script with a non-zero exit on failure:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build every CUDA source of the port (one ``nvcc`` each, all at once);
3. every kernel against its plain PyTorch version at the shapes its path
   gives it (full-width Mamba-2-130M, 2 clients: a bf16 buffer and an f32
   buffer; the FedBiOAcc buffers for the STORM pair, FedBiO's for
   ``sgd3_step``, FedAvg's for ``momsgd3_step``, the f32 inputs of the
   compressed reductions of ``fedbioacc_int8_topk`` for ``quantpack`` and
   ``quantunpack``), bit for bit, with median times over CUDA events (for
   ``quantpack`` also the two-pass kernel's time on the same inputs,
   called past the wrapper; where one PyTorch call computes the same
   function, its time too, after holding it bit for bit to the kernel:
   ``torch.mul`` for ``quantunpack``, ``torch.addcmul`` for
   ``sgd3_step``); then
   tiles holding NaN, +Inf and -Inf through
   each pack kernel, bit for bit, unpacking to all NaN as the reference's
   do; then the times of the compressed path's top-k and of its whole
   compressed reduction at the bf16 buffer's shape; then ``storm3_step``,
   ``sgd3_step`` and ``momsgd3_step`` with tile tables gated by a
   participation mask that leaves clients out (``storm3_step`` at the
   FedBiOAcc-Local buffers of 4 clients, 2 left out, again at the
   straggler path's buffers of 8 clients, block 256, gated by round 0's
   arrivals so that unsampled and late clients are left out, and at the
   faulty path's buffers of 8 clients, gated by the first faulted round's
   ``keep`` mask that drops two clients under the spec edited to
   ``dropout_rate`` 0.25), bit for bit
   against their plain versions (run a client row at a time), the
   left-out rows equal to their input bits, with inf/NaN in a left-out
   client's gradient (a late one on the straggler path) zeroed by
   ``flat.mask_buffers``; then the two reductions of the communication
   schedule at their paths' full-depth bf16 buffers, one run spanning the
   buffer (``reductions_phase``): the arrival-weighted int8 + top-k 10 %
   mean with error feedback (``fedbioacc_straggler_int8_topk``, 8
   clients, block 256, round 0's arrivals) and the grouped int8 mean
   (``fedbioacc_hierarchical``, 4 clients in 2 pods, round 0's
   participants), each bit for bit (rows and error feedback) against the
   same reduction on the CPU over the first ``HOST_COLUMNS`` columns of
   the same rows, with its median time, launches and transient memory;
3b. the pytree ``storm_update`` (``repro_torch.kernels.storm``) over the
   full-width Mamba-2-130M parameter tree (seeded on the card, bf16 and f32
   leaves) with f32 momentum and gradient trees, then with bf16 momentum,
   then over an odd tree (a leaf of 70,001 elements, a bf16/bf16 group):
   every leaf bit for bit against the plain version, the launches counted
   over each run alone (one per dtype group, every other kernel never),
   median CUDA-event times of the kernel over the tree's concatenated
   groups and of the whole entry point (concatenation plus launches);
4. a reduced-model cross-check of each path: two steps on the card against
   two on the CPU from the same initial state and batches (within 1e-4 of
   each buffer's norm: reduction orders differ between the two devices;
   the sampled path's masks and staleness counters equal on both).
   The compressed path's top-k and int8 rounding are discontinuous, so
   there every entry that one device kept or rounded otherwise than the
   other must lie near its threshold or half-way point
   (``repro_torch.testing``: ``topk_flips``, ``int8_flips``), and the
   1e-4 holds off the entries and columns those flips reach, the error
   feedback included.  The straggler path is cross-checked under each of
   its late policies (``drop``, ``carry``, ``cancel``) over two rounds
   (four steps), and each step's arrivals, extensions, effective and next
   deadline, and the staleness counters, must be equal on both devices
   (the host decides them from the deadline each state carries).  Then
   the train CLI on the reduced straggler spec: a run hard-exits after
   its step-2 checkpoint (``--crash-at-step 2``, exit 17); ``--resume``
   on the card must end as the uninterrupted run does, bit for bit (each
   logged loss, arrival set and deadline; each array of the final
   checkpoint), and the same checkpoint resumed with ``--device cpu``
   within 1e-4 of each buffer's norm, its arrivals, deadlines and
   staleness counters equal.  Then the reduced faulty spec over two
   rounds (four steps), card against CPU, under ``clip`` (as committed),
   ``trim``, ``mean``, ``clip`` with ``dropout_rate`` 0.25, and with
   ``robustness`` null: each step's fault masks and health verdicts
   equal on both devices, the buffers within 1e-4 of each one's norm until
   the last step; there the oracles run at an aggregate the byzantine
   rows left far off, so a buffer that moves by more than
   ``ILL_CONDITIONED`` when the CPU's entering variables move by 1e-7 is
   only logged (the variables must not be such), and each guarded
   reduction the card ran is rerun on the CPU on the card's input rows
   and held to 1e-4; the unguarded run non-finite on both.  Then the train
   CLI with faults: a spec edited to ``nan_rate`` 1.0 from round 1,
   screen off, retry budget 2 rolls back twice to step 2, writes
   ``<ckpt-dir>/diagnostic`` and exits non-zero naming round 4; the
   committed spec under ``--max-restarts 1 --restart-backoff 0
   --crash-at-step 2`` exits 0 and ends bit for bit as the uninterrupted
   run (every line, every array of the final checkpoint, ``retries``).
   These two train CLI checks run their subprocesses from threads of their
   own, and phase 9's generator check and (a) run in a child process,
   beside the cross-checks of this phase, which time nothing.
   Then telemetry: the reduced ``fedbioacc_telemetry.json`` through the
   train CLI in process for 4 steps with ``--telemetry-sink``, on the card
   and on the CPU from the CPU's initial state: both streams pass
   ``repro_torch.telemetry.validate``, their ``(event, step, round)``
   sequences and ``comm`` events are equal, every in-band and evaluation
   metric within ``METRIC_TOL`` (relative).  The two paths of the
   communication schedule (phase 5's last two), reduced, over two rounds
   (``round_cross_check``): each round starts the card from the CPU's
   state, and after it every entry that top-k or int8 rounding decided
   otherwise must lie within its bound (each compressed run mapped back to
   its buffer's columns), the buffers within 1e-4 of each one's norm off
   the flips' columns and the error feedback off the flipped entries, the
   round's mask, arrivals and staleness counters equal on both.  Then the
   train CLI with ``--hierarchy-period 2 --comm-every u=2`` (the reduced
   ``fedbioacc.json``, 4 clients): stopped after step 1, inside pod-local
   round 1, and resumed, bit for bit the uninterrupted run; its ``comm``
   events ``round_bytes``' (``cli_schedule_phase``);
4b. the sharded substrate (``sharded_phase``): 8 ranks spawned beside
   phase 4, a ``[4, 2]`` mesh over gloo, every rank on ``cuda:0``, each
   running the train CLI's ``main`` in process: (a) the committed
   ``fedbioacc_sharded_overlap.json`` at its own size for 4 steps on the
   CPU, and steps 3-4 again on the card resumed from the CPU's step-2
   checkpoint, each field of the two final checkpoints (gathered on rank
   0) within ``SHARDED_TOL`` of its norm; (b) an edit at full Mamba-2-130M
   width (bf16, ``MAIN_LAYERS`` layers, 4 clients, 512 tokens) for 4 steps
   with overlap: ``storm3_step`` launched once per dtype buffer a step on
   every rank (counted over the ranks), each rank's step times and peak
   memory, the variable reduction's issue and wait times beside the same
   reduction's time in a sequential run of the edit (its share the overlap
   hides), and the run resumed from its step-2 checkpoint by a second
   ``main`` ending bit for bit as the uninterrupted one; (c)
   ``fedbioacc_int8_topk.json`` edited to the mesh at that width (4
   clients, 2 steps): ``quantpack``/``quantunpack`` launched on every
   rank's block (the int8 wire between them), a finite loss; (d) the
   straggler, faulty and telemetry specs edited to the mesh at their own
   size, 4 steps on the CPU and steps 3-4 on the card from the CPU's
   step-2 checkpoint: each step's round (arrivals and deadline, faults
   and the screened clients) equal on both devices, each field within
   ``SHARDED_TOL`` of its norm (the faulty spec's ill-conditioned last
   momenta only logged: ROADMAP queue 3 item 15), the telemetry spec's
   in-band metrics within ``GUARD_METRIC_TOL``; (e) at full width
   (``MAIN_LAYERS`` layers) on the card, the runs of ``FULL_RUNS``, one
   round each: the straggler spec (8 clients); the faulty spec (8
   clients) with its faults from round 0 on (NaN and ×25 sends, the
   screen, the z-score, clip) and the health metrics, every NaN sender
   screened, its metric passes (the health screen among them) and guarded
   means at the communication step held against the same on CPU copies
   of their inputs (the means within ``SHARDED_TOL``, their verdicts
   equal), each guarded mean's ms on the card; the faulty spec cut to 4
   clients so that round 0 sends NaN at retry 0 and rolls back once, to
   step 1, on every rank (``ROLLBACK_EDITS``), the rollback's host
   snapshot and restore seconds on each rank; the telemetry spec with
   int8 sends and the compression metrics, its metric passes (the
   quantization pass among them) at the communication step against CPU
   copies; every rank's ``storm3_step`` launches (one a dtype buffer a
   step, gated by the round) and ``quantpack``/``quantunpack`` launches,
   the reductions' ms through gloo, each rank's step ms and peak bytes.
   Its step times include phase 4's load on the host;
4c. the static verifier (``analysis_phase``), run right after phase 2,
   alone on the card (its gloo ranks hung in the CUDA driver when started
   beside phase 4's load): ``python -m repro_torch.analysis --all
   experiments/ --lint src/repro_torch`` (a subprocess in a session of its
   own)
   must exit 0 with an OK line for each committed spec (one recorded step
   each: the S2xx step traces, and on ranks the W1xx collective and wire
   audits, the sharded spec's on its 8 gloo ranks on ``cuda:0`` with
   ``storm3_step`` calls in its recorded step, the compressed spec's int8
   wire probe on 2) and a clean lint; then ``fedbioacc_local.json`` at
   mesh (1, 1) with an extra 7-element f32 all-reduce wrapped into its
   step (``testing.seeded_all_reduce``), in a 1-rank child on the card,
   must exit 1 with W101 alone;
4d. the dry run (``launch/dryrun.py``), which allocates nothing on the
   card and times nothing, in two children beside phases 5-9: (a)
   ``--experiment`` on the ten committed specs on CUDA fakes (the sharded
   one on rank 0 of a fake group of 8; ``dryrun_specs``); (b) the
   full-width ``fedbioacc.json`` (``MAIN_LAYERS`` layers) traced, and run
   once for real after phase 5 (``dryrun_path``): FLOPs equal
   (``FlopCounterMode`` over the real step plus the launched kernels'
   ``work``), argument bytes equal, the predicted peak within
   ``PEAK_TOL`` of the real step's ``max_memory_allocated()`` increase;
   (c) mamba2-130m's ``prefill_32k`` and ``decode_32k`` and llama3-405b's
   ``train_4k`` (``DRYRUN_TRAIN``) at full width and ``MAIN_LAYERS``
   layers; (d) phase 4b's full-width spec traced on a fake group of 8,
   whose collectives must be the multiset 4b's rank 0 recorded at the same
   step (round 1's communication step of its run (b)), and
   ``--fused-mesh 4,2`` of mamba2-130m's ``train_4k``; no trace may move
   ``torch.cuda.memory_allocated()`` (``dryrun_checks``);
5. the paths: ``experiments/fedbioacc.json``, ``fedbio.json``,
   ``fedbio_local.json``, ``fedavg.json``, ``fedbioacc_int8_topk.json``,
   ``fedbioacc_local.json``, ``fedbioacc_straggler.json``,
   ``fedbioacc_faulty.json`` and ``fedbioacc_telemetry.json``, each at full
   Mamba-2-130M width (bf16, 2 clients, or a sampled, faulty or telemetry
   path's own: 4 of which 2 take part a round, the straggler path's 8 of
   which 6 are sampled and those that beat the round's deadline arrive,
   the faulty path's 8, the telemetry path's 4; ``MAIN_LAYERS`` of the
   24 layers; 1
   sequence of 512 tokens each — two SSD chunks), four steps (two
   communication rounds), with the kernels' launch counts taken over that
   path's run alone (as ``PATHS`` lists them, every other kernel never; the
   compressed path's packs all on the cluster kernel, counted per step) and
   a finite validation loss; the sampled path also logs each round's mask
   and checks on the card that every step leaves the non-participants'
   variable and momentum rows at their entering bits, and that each round
   leaves the participants' communicated rows (x, ν) bit-identical and
   their private ones (y, ω) not; the straggler path logs each round's
   sampled set, arrivals, quorum, extensions and effective and next
   deadline beside ``simulate_rounds``' simulated round clock (host
   arithmetic in simulated seconds) and the share of its step time spent
   on the oracles of clients that did not arrive (CUDA events around each
   client's oracle, no synchronization inside a step), and checks that
   every round's arrivals make quorum, that the decision each step records
   has ``simulate_rounds``' arrival count, quorum, extensions and
   effective deadline, that the arrivals are the sampled clients whose
   drawn time is within that deadline, and that every step leaves the
   non-arrivals' rows at their entering bits (``drop``); it runs with
   every telemetry group that applies to it (norms, drift, health,
   stragglers), and each step's in-band straggler metrics must be the
   decision the engine recorded; after its step
   2, outside the timed steps, the straggler path's state is checkpointed
   (``repro_torch.checkpoint``, once the directory is known to hold twice
   the state) with its bytes and the seconds to save and to load logged,
   and after step 4 a fresh build of the checkpoint's embedded spec loads
   it into its own initial state on the card and runs steps 3-4 on the
   same batches: every buffer, the step, the staleness counters and the
   deadline bit for bit those of the uninterrupted run, each step's
   arrivals, extensions and deadlines equal, ``storm3_step`` once per
   buffer a step (counted into the kernels line) and no other kernel;
   the faulty path (``fedbioacc_faulty.json``, its own 8 clients, round 1
   faulted: NaN clients screened, byzantine ×25 ones clipped) runs
   through a ``RollbackGuard`` as the train CLI runs it with
   ``--log-every 2`` (host snapshots, after checking the host has the
   ring's bytes available), each guarded reduction's verdict held to the
   screen recomputed from scratch and timed between CUDA events, the state
   finite after every round; after step 4 a non-finite loss is observed in
   place of the real one: the step-2 snapshot must come back into the
   live tensors bit for bit, ``retry`` 1, and round 1 is rerun on its
   ``(1, 1)`` draws (12 ``storm3_step`` launches in all); its step times,
   the guarded reductions' share of each, peak memory, snapshot and
   restore seconds and the ring's host bytes are logged; the telemetry
   path runs through ``repro_torch.launch.train.main`` in process
   (``--device cuda``, ``--log-every 2``, a sink in a temporary
   directory), each step between two synchronizations and each metric
   pass between CUDA events: its stream must validate with both comm
   events reconciled, its in-band values be finite, its launches as
   ``PATHS`` says; its step times, the passes' share of each step, the
   peak memory and the ``launch.metrics`` summary are logged; then the
   two paths of the communication schedule, edits of committed specs
   (``HIER_EDITS``; the straggler spec with the compressed spec's
   compression), their bytes reckoned from the layout first
   (``_schedule_bytes``): ``fedbioacc_hierarchical`` (4 clients, 3
   sampled a round, 2 pods, u at a cadence of 2, int8) must leave after
   pod-local round 1 each pod's participants' x, y, ν and ω rows
   bit-identical and the pods' not, no two participants' u and q rows
   equal, and after global round 2 every participant's rows equal;
   ``fedbioacc_straggler_int8_topk`` (8 clients, 6 sampled, ``drop``)
   the arrivals' rows equal after each round and the late clients'
   variable, momentum and error-feedback rows at their entering bits;
   both leave non-participants' rows at their entering bits every step;
   each masked reduction is timed between CUDA events (its share of the
   step logged) and each round's elements reduced must be what
   ``round_bytes`` of the run's comm plan (the train CLI's ``comm``
   event) says, round 1 of the hierarchical path without u;
5b. the unfused tree path (``execution.fuse_storm`` false, the
   reference's default), microbatching and remat (``tree_path_phase``):
   (a) each of the five algorithms' committed spec edited to the tree
   path (``TREE_EDITS``: 4 clients in 2 pods, ``hierarchy_period`` 2, the
   ``uniform`` sampler taking 2 a round, one step a round), reduced, two
   rounds on the card against two on the CPU from the same initial state
   and batches, each state field within ``TREE_TOL`` of its norm, no
   kernel launched; (b) ``fedbioacc.json`` edited to the tree path at full
   width (``MAIN_LAYERS``, 2 clients, 4 steps) through
   ``repro_torch.launch.train.main`` in process, as a user runs the
   reference's default CLI path: each step between CUDA events, the peak
   memory, a finite val loss, no kernel of the fused engine launched (the
   storm family and ``quantpack`` read 0); the same run stopped after its
   step-2 checkpoint (``--crash-at-step 2``, the hard exit caught) and
   resumed must end as the uninterrupted run, every line and every array
   of the final checkpoint bit for bit; ``federation.evaluate.
   eval_federated`` on the uninterrupted run's final state (loaded into a
   fresh build) must give finite figures and a loss per client, timed; (c) ``fedbioacc.json`` at full
   width with ``n_micro`` 2 over 2 sequences a client, with remat and
   without (``MICRO_EDITS``), 2 steps each from the same state and
   batches: the step times (CUDA events) and peaks logged, the two runs'
   buffers bit for bit (a remat-free repeat decides, should they differ,
   whether an operation on the path is not deterministic), ``storm3_step``
   once per buffer a step;
6. the model kernels against their plain versions at the serving path's
   shapes (full-width RecurrentGemma-9B, batch 2, prompt 4096): the RG-LRU
   scan at [2, 4096, 4096] f32 bit for bit on the TMA kernel (timed beside
   the lanes kernel on the same inputs, called past the wrapper), plus a
   ragged shape with h0 on each kernel;
   the flash attention at q [2, 4096, 16, 256], k/v [2, 4096, 1, 256],
   causal, window 2048, in bf16 (2e-2 and 2 bf16 ulps, the tensor-core
   kernel ``flash_fwd_tc``; two plain versions with a kernel's fault, p
   rounded to bf16 before p.v and a key tile skipped, must break the ulp
   limit) and f32 (2e-5, ``flash_fwd``), plus a window-0, soft-capped case
   in each dtype; median CUDA-event times, the bound, and
   for the attention ``scaled_dot_product_attention`` with the band as a
   boolean mask (``library_ms``, never on the path);
7. a reduced serving cross-check: the reduced RecurrentGemma (f32, 3
   layers) prefills a prompt of 100 and decodes 8 teacher-forced tokens on
   the card with both kernels and on the CPU with both plain versions, from
   the same params; every step's logits agree within 1e-4 of the largest;
8. the serving path, last: ``repro_torch.launch.serve.main`` on full-width
   RecurrentGemma-9B (10.44 B parameters, bf16, seeded init on the card),
   batch 2, prompt 4096, 16 generated tokens, with the launch counts over
   that run alone
   (``SERVE_LAUNCHES``: the scan once per ``rec`` layer, all on the TMA
   kernel, the attention once per ``local`` layer, every other kernel
   never), finite logits, and its
   prefill time, decode time per step and peak memory;
8b. the dense and MoE families and continuous batching: the flash
   attention at their prefill shapes (``FLASH_CASES``: granite-8b q
   [1, 517 | 2047, 32, 128], kv 8 heads; gemma2-2b [2, 4096, 8, 256], kv
   4, window 4096 and 0, soft cap 50; olmoe-1b-7b [4, 4096, 16, 128], kv
   16), bf16 within 2e-2 and 2 bf16 ulps (both fault versions breaking
   the limit), granite's ragged 517 also f32 within 2e-5, timed beside
   the plain version and SDPA; a reduced prefill plus 8 decode steps of
   each of gemma2-2b, granite-8b, granite-3-8b, llama3-405b, olmoe-1b-7b,
   granite-moe-1b-a400m and mamba2-130m, card against CPU within 1e-4 of
   the largest logit (launches: the attention once per attention layer);
   a reduced ``ServeEngine`` (5 requests through 2 slots) of granite-8b,
   mamba2-130m, recurrentgemma-9b and olmoe-1b-7b, each request's tokens
   held to its isolated greedy decode on the card (at each step the
   engine's logits within 1e-4 of the largest isolated logit; a step whose
   top-2 margin is no more than twice their difference, or the arch's
   card/CPU difference, is logged and ends that request's comparison);
   then at full width, bf16, each model freed before the next:
   granite-8b (8.25 B parameters) through ``ServeEngine``, 8 requests of
   ``ENGINE_PROMPTS`` tokens with ``ENGINE_BUDGETS`` through 4 slots (36
   attention launches a prefill, 288 in all), each request held to its
   isolated decode at batch 1 and at the pool's batch of 4 (logits within
   5e-2 of the largest), the time to each first token, the decode steps
   and the peak memory logged; gemma2-2b (batch 2, prompt 4096, 16 tokens,
   26 launches) and olmoe-1b-7b (batch 4, prompt 4096, 16 tokens, 16
   launches; its prefill's 16,384 tokens take the capacity dispatch)
   through ``launch/serve.py``; mamba2-130m through ``ServeEngine`` as
   granite-8b, no kernel (the flash cases also take hubert-xlarge's
   encoder, q [4, 1500, 16, 80], not causal, in bf16 and f32, and
   internvl2-76b's prefill, [2, 1280, 64, 128], kv 8, causal);
8c. the audio and VLM front ends and every family's training: a reduced
   internvl2-76b prefill (8 patches + 100 tokens) and 8 decode steps, and
   a reduced hubert-xlarge forward over 100 frames, card (kernels) against
   CPU (plain versions) within 1e-4 of the largest logit; two reduced
   FedBiOAcc steps of ``experiments/fedbioacc.json`` with the arch edited
   to each of granite-moe-1b-a400m, hubert-xlarge, gemma2-2b,
   recurrentgemma-9b and internvl2-76b, card against CPU as phase 4 (1e-4
   of each buffer's norm); then those five at full width (bf16, 2
   clients, 1 sequence of 512 each, ``FAMILY_STEPS`` steps) at the first
   depth of ``TRAIN_DEPTHS`` whose flat buffers, reckoned from the layout
   (``_flat_bytes``), fit the card and whose steps do not run out of
   memory, each depth skipped logged with the bytes that stopped it: the
   step times (CUDA events), the peak memory, the validation loss before
   and after (finite), ``storm3_step`` once per buffer a step and no other
   kernel; ``storm3_step`` bit for bit against its plain version at the
   largest buffers a family trained on (a phase-3 entry, timed beside its
   bound); internvl2-76b served through ``launch/serve.py`` at full width
   with ``VLM_LAYERS`` of its 80 layers (batch 2, 256 patches + 1,024
   prompt tokens, 16 new tokens; the attention once a layer); and
   hubert-xlarge's encoder at full width, all 48 layers, ``Model.forward``
   with ``use_flash`` over 4 clips of 1,500 frames (the attention once a
   layer at head dim 80), finite logits of the expected shape, timed, its
   logits beside the same forward with the plain attention;
9. the paper's problems (``repro_torch.core``; the generator check, (a)
   and the examples ``repro_torch.examples.quickstart`` and
   ``fair_federated_learning``, two subprocesses at once on the card that
   must each exit 0 after its own checks, in a child process started in
   phase 4):
   the Threefry generator on
   the card against the CPU (keys, bits, integers, uniforms, permutations
   bit for bit, normals within 4 ulps); (a) two rounds of each of the
   eight algorithms (Algorithms 1-4 and the Table-1 baselines) on the
   quadratic (M 8, dx = dy = 10), data cleaning (n_train 256) and
   hyper-representation (defaults), card against CPU from the same keys
   and arrays within 1e-4 of each state leaf's norm, Algorithms 1-4 also
   with ``fuse_storm`` at tiles of 64 and 1024, each fused run within
   rtol/atol 1e-5 of the card's tree loop and launching its kernel once a
   local step (CommFedBiO's top-k decisions bounded and aligned as in
   phase 4); (b) the two examples with their settings, ``fuse_storm`` on,
   200 rounds: FedBiOAcc's data-cleaning AUC above 0.75, FedBiOAcc-Local's
   and FedBiO-Local's upper losses falling, each beside the reference's
   CPU result, with one launch a local step; (c) data cleaning (FedBiOAcc,
   FedBiO) and hyper-representation (FedBiOAcc-Local, FedBiO-Local) at
   MNIST's shape (60,000 × 784 features, 10 classes; 6,000 a client for
   hyper-representation; synthetic, from the seed), 10 clients, 20 rounds:
   round times, peak memory, launches (one ``storm3_step`` or
   ``sgd3_step`` a local step, every other kernel never) and a finite
   upper objective; then both kernels bit for bit on those runs' buffers,
   timed beside their plain versions.

The line before the last is one JSON object describing each kernel, its
``launches`` summed over the paths (phase 9's (b) and (c) included); the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import io
import itertools
import json
import math
import multiprocessing
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable, NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# the full-width training runs of phase 8c fill the card: let the caching
# allocator grow its segments rather than leave freed blocks stranded
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

from repro_torch import random as jr  # noqa: E402
from repro_torch.api import Experiment, build  # noqa: E402
from repro_torch.checkpoint import (checkpoint_metadata,  # noqa: E402
                                    load_checkpoint, load_experiment,
                                    save_checkpoint)
from repro_torch.config import FederatedConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import baselines, make_algorithm, problems  # noqa: E402
from repro_torch.core.fedbio import mean_over_clients  # noqa: E402
from repro_torch.core.tree_util import (tree_leaves, tree_map,  # noqa: E402
                                        tree_structure)
from repro_torch.examples import data_cleaning as cleaning_ex  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    hyper_representation as hyperrep_ex)
from repro_torch.federation import trainer  # noqa: E402
from repro_torch.federation.evaluate import eval_federated  # noqa: E402
from repro_torch.federation.faults import (RollbackGuard,  # noqa: E402
                                           make_faults)
from repro_torch.federation.stragglers import simulate_rounds  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.flash import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash.ref import (band_mask,  # noqa: E402
                                           flash_attention_ref)
from repro_torch.kernels.lru import ops as lru_ops  # noqa: E402
from repro_torch.kernels.lru.ref import lru_scan_ref  # noqa: E402
from repro_torch.kernels.storm import kernel as storm  # noqa: E402
from repro_torch.kernels.storm import storm_update  # noqa: E402
from repro_torch.kernels.storm import quantpack as qp  # noqa: E402
from repro_torch.kernels.storm import ref as storm_ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import metrics as tel_metrics  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.layers import MOE_DENSE_TOKEN_LIMIT  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim import flat  # noqa: E402
from repro_torch.optim import sequences as seqs  # noqa: E402
from repro_torch.optim.sequences import FlatState  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.telemetry import read_events, validate_events  # noqa: E402
from repro_torch.telemetry.comm import comm_plan, round_bytes  # noqa: E402
from repro_torch.testing import (BF16_FLOOR, BF16_ULPS,  # noqa: E402
                                 bf16_ulps, flash_attention_fault,
                                 int8_flips, isolated_greedy, leaf_topk_flips,
                                 seeded_all_reduce, top2_margin, topk_flips)

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12            # H100 SXM, f32 outside the tensor cores
BF16_TC_FLOPS_PER_S = 989e12       # H100 SXM, dense bf16 tensor cores
# path (committed spec) → what its four full-width steps launch over its two
# dtype buffers: the update kernel once per buffer per step; the compressed
# path also packs and unpacks the variables and the momenta of each buffer
# at both communication steps
PATHS = {"fedbioacc": {"storm3_step": 8, "storm_update": 0},
         "fedbio": {"sgd3_step": 8, "storm_update": 0},
         "fedbio_local": {"sgd3_step": 8, "storm_update": 0},
         "fedavg": {"momsgd3_step": 8, "storm_update": 0},
         "fedbioacc_int8_topk": {"storm3_step": 8, "quantpack": 8,
                                 "quantunpack": 8, "storm_update": 0},
         "fedbioacc_local": {"storm3_step": 8, "storm_update": 0},
         "fedbioacc_straggler": {"storm3_step": 8, "storm_update": 0},
         "fedbioacc_faulty": {"storm3_step": 8, "storm_update": 0},
         "fedbioacc_telemetry": {"storm3_step": 8, "storm_update": 0},
         # pod-local round 1 packs x and y of both buffers (u waits for its
         # cadence), global round 2 x and y, then u of the bf16 buffer (the
         # f32 buffer holds no u), each for the variables and the momenta
         "fedbioacc_hierarchical": {"storm3_step": 8, "quantpack": 10,
                                    "quantunpack": 10, "storm_update": 0},
         "fedbioacc_straggler_int8_topk": {"storm3_step": 8, "quantpack": 8,
                                           "quantunpack": 8,
                                           "storm_update": 0}}
COMPRESSED = "fedbioacc_int8_topk"
SAMPLED = "fedbioacc_local"
STRAGGLED = "fedbioacc_straggler"
FAULTY = "fedbioacc_faulty"
TELEMETRY = "fedbioacc_telemetry"
# the two paths of the communication schedule, edits of committed specs
# (no file of their own): fedbioacc.json at 4 clients, 3 sampled a round,
# in 2 pods that average alone at round 1 and with each other at round 2,
# u at a cadence of 2, int8 sends; and the straggler spec with the
# compressed spec's compression (int8, top-k 10 %, error feedback), the
# arrival-weighted compressed mean
HIERARCHICAL = "fedbioacc_hierarchical"
STRAGGLED_INT8 = "fedbioacc_straggler_int8_topk"
HIER_EDITS = {"problem.num_clients": 4, "schedule.steps": 4,
              "schedule.hierarchy_period": 2, "schedule.hierarchy_groups": 2,
              "schedule.comm_every": {"u": 2}, "compression.quant": "int8",
              "participation.sampler": "uniform",
              "participation.clients_per_round": 3}
# phase 3 holds the reductions of those paths bit for bit to the CPU's
# over this many leading columns of their buffers (a whole number of
# tiles: top-k, quantization and the means are column- or tile-local)
HOST_COLUMNS = 1 << 22
# clients at full width; a path that samples its clients, injects faults
# or reports telemetry keeps the spec's own count, so that the sampler
# leaves clients out, the screen has its participants and the drift its
# four clients
CLIENTS = 2
# the faulty path: the dropout rate of the edit that gates phase 3's
# launches and one cross-check of phase 4; the guard observes at the steps
# the train CLI does with --log-every 2; a buffer whose last step moves by
# more than this (relative) when the entering variables move by 1e-7 is
# too ill-conditioned to compare between devices end to end
FAULT_DROPOUT = 0.25
FAULT_LOG_EVERY = 2
ILL_CONDITIONED = 1e-3
# the straggler path is checkpointed after this many of its steps and
# resumed from there
RESUME_AT = 2
# the phase-5 paths keep Mamba-2-130M's published widths and cut its depth
# to this many of its 24 layers, so that the script fits in its time (6
# until phases 8b and 8c came; the communication schedule's two paths kept
# 6 until phase 5b came; 3 until phase 4b came; 2 until phase 4c came)
MAIN_LAYERS = 1
# the telemetry paths: the train CLI evaluates at steps 1, 2 and 4; card and
# CPU in-band metrics agree within this (relative)
TEL_LOG_EVERY = 2
METRIC_TOL = 1e-4
# the metric passes of the engine's telemetry groups (timed in phase 5)
METRIC_PASSES = ("section_norms", "section_drift", "quant_roundtrip_err",
                 "health_screen")
KERNEL_RUNS, PLAIN_RUNS = 30, 10
# the serving path: full-width RecurrentGemma-9B prefill and greedy decode
SERVE_ARCH = "recurrentgemma-9b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 2, 4096, 8
# its 26 rec layers scan once each and its 12 local layers attend once
# each, all in the prefill; decode runs neither kernel
SERVE_LAUNCHES = {"lru_scan": 26, "flash_attention": 12, "storm_update": 0}
# the pytree storm_update over the Mamba-2-130M tree: one launch per
# (param dtype, momentum dtype) group, bf16 and f32 leaves
TREE_ARCH, TREE_LR, TREE_DECAY = "mamba2-130m", 0.05, 0.9
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# phase 8b, the dense and MoE families and continuous batching: the
# attention at their prefill shapes (arch, batch, prompt, layer kind:
# granite-8b's ragged single prompts, GQA 32:8 and D 128; gemma2-2b's
# alternating local (window 4096) and global layers, GQA 8:4, D 256, soft
# cap 50; olmoe-1b-7b's 16:16 heads, D 128)
FLASH_CASES = (("granite-8b", 1, 517, "attn"), ("granite-8b", 1, 2047, "attn"),
               ("gemma2-2b", 2, 4096, "local"), ("gemma2-2b", 2, 4096, "attn"),
               ("olmoe-1b-7b", 4, 4096, "attn"),
               # phase 8c: hubert-xlarge's encoder (16:16 heads, D 80, not
               # causal, 1,500 frames: ragged against the 64-key tiles) and
               # internvl2-76b's prefill (256 patches + 1,024 tokens, 64:8,
               # D 128)
               ("hubert-xlarge", 4, 1500, "attn"),
               ("internvl2-76b", 2, 1280, "attn"))
# the reduced card/CPU cross-checks besides RecurrentGemma's, and the
# reduced engines
FAMILY_ARCHS = ("gemma2-2b", "granite-8b", "granite-3-8b", "llama3-405b",
                "olmoe-1b-7b", "granite-moe-1b-a400m", "mamba2-130m")
ENGINE_ARCHS = ("granite-8b", "mamba2-130m", "recurrentgemma-9b",
                "olmoe-1b-7b")
# chat-style traffic at full width: mixed prompts into a fixed pool of
# decode slots
ENGINE_PROMPTS = (200, 517, 777, 1031, 1300, 1555, 2047, 1800)
ENGINE_BUDGETS = (8, 24, 12, 20, 16, 10, 22, 14)
ENGINE_SLOTS = 4
# an engine's logits against the isolated decode's at a compared step
# (the same inputs at another batch size), relative to the largest logit
ENGINE_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# batched serving through launch/serve.py: (batch, prompt, tokens); the
# olmoe prefill's 16,384 tokens take the capacity dispatch
BATCHED = {"gemma2-2b": (2, 4096, 16), "olmoe-1b-7b": (4, 4096, 16),
           "internvl2-76b": (2, 1024, 16)}
# phase 8c, the front ends and every family's training: FedBiOAcc
# (experiments/fedbioacc.json, the arch edited) at full width, 2 clients, 1
# sequence of 512 each, bf16, FAMILY_STEPS steps; per arch the depths to
# try in order (None: all layers), the first whose flat buffers fit the
# card and whose step does not run out of memory taken: gemma2-2b halved
# from its 26 layers, recurrentgemma-9b in whole (rec, rec, local) units,
# internvl2-76b at one layer
FAMILY_STEPS = 1
TRAIN_DEPTHS = (("granite-moe-1b-a400m", (None,)),
                ("hubert-xlarge", (None,)),
                ("gemma2-2b", (None, 13, 6, 3, 1)),
                ("recurrentgemma-9b", (6, 3)),
                ("internvl2-76b", (1,)))
# internvl2-76b served at full width through launch/serve.py with this
# many of its 80 layers (~31.6 GB of bf16 weights); hubert-xlarge encodes
# ENCODE_BATCH clips of ENCODE_FRAMES frames (30 s at 50 Hz) at all 48
VLM_LAYERS = 16
ENCODE_BATCH, ENCODE_FRAMES = 4, 1500
# the storm3_step check at a family's buffers compares the plain version a
# slice of this many tiles at a time (it is elementwise over tiles)
CHECK_TILES = 4096
# the families whose training must fit at one of its depths
REQUIRED_TRAIN = ("granite-moe-1b-a400m", "hubert-xlarge", "gemma2-2b")
# phase 5b, the unfused tree path: the five algorithms' committed specs
# edited so (4 clients in 2 pods: round 1 pod-local, round 2 global; 2 of
# 4 sampled a round; one step a round), card against CPU within TREE_TOL
# of each field's norm; n_micro 2 over 2 sequences a client, with remat
# and without, at full width
TREE_ALGOS = ("fedbioacc", "fedbio", "fedbio_local", "fedavg",
              "fedbioacc_local")
TREE_EDITS = {"execution.fuse_storm": False, "problem.num_clients": 4,
              "schedule.local_steps": 1, "schedule.hierarchy_period": 2,
              "schedule.hierarchy_groups": 2,
              "participation.sampler": "uniform",
              "participation.clients_per_round": 2}
TREE_TOL = 1e-4
MICRO_EDITS = {"execution.n_micro": 2, "problem.per_client": 2,
               "schedule.steps": 2}


def log(msg: str) -> None:
    # one write a line: the train CLI checks log from threads of their own
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, runs: int) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` calls, each between two
    CUDA events, after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def reset_counts() -> None:
    storm.reset_counts()
    qp.reset_counts()
    lru_ops.reset_counts()
    flash_ops.reset_counts()


def launch_counts() -> dict:
    return {**storm.LAUNCHES, **qp.LAUNCHES, **lru_ops.LAUNCHES,
            **flash_ops.LAUNCHES}


def variant_counts() -> dict:
    """Launches per kernel of the wrappers that choose between two."""
    return {**qp.VARIANTS, **lru_ops.VARIANTS}


def raw_ms(fn_name: str, lib, *args) -> float:
    """Median time of one kernel of ``lib`` called past its wrapper (no
    launch counted), on the current stream; raises if it fails."""
    def call():
        err = getattr(lib, fn_name)(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"{fn_name} failed with CUDA error {err}")
    return timed_ms(call, KERNEL_RUNS)


@contextlib.contextmanager
def _depth(layers: int):
    """Builds inside (``build``, ``launch/serve.py`` and this script's own
    lookups) take the published widths of their arch with only its first
    ``layers`` layers."""
    from repro_torch import configs
    orig = configs.get_config
    homes = (configs, serve, dryrun)

    def cut(name):
        return dataclasses.replace(orig(name), num_layers=layers)

    for home in homes:
        home.get_config = cut
    globals()["get_config"] = cut
    try:
        yield
    finally:
        for home in homes:
            home.get_config = orig
        globals()["get_config"] = orig


def full_width_experiment(exp: Experiment) -> Experiment:
    own = (exp.participation.sampler != "full" or exp.faults is not None
           or exp.telemetry is not None)
    return exp.edit(**{"problem.reduced": False,
                       "problem.num_clients": (exp.problem.num_clients
                                               if own else CLIENTS),
                       "problem.per_client": 1, "problem.seq_len": 512,
                       "schedule.steps": 4})


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at the main path's shapes
# ---------------------------------------------------------------------------

class Kernel(NamedTuple):
    wrapper: Callable
    plain: Callable
    inputs: Callable   # (n, tiles, grp, gen, dev) -> the call's tensors
    replaces: str      # the TPU kernel
    path: str          # the path whose buffers it is held and timed at
    source: str = "src/repro_torch/kernels/csrc/storm3.cu"
    # one PyTorch call that computes the same function (called as ``plain``
    # is), or None and the reason there is none
    library: Callable | None = None
    no_library: str = "no single PyTorch call applies per-tile tables"


def _update_inputs(n_in: int, n_tables: int):
    """p in the buffer's dtype, ``n_in`` f32 streams, per-tile tables."""
    def make(n, tiles, grp, gen, dev):
        p = torch.randn(n, generator=gen, device=dev).to(grp.dtype)
        streams = [torch.randn(n, generator=gen, device=dev)
                   for _ in range(n_in)]
        tables = [0.1 * torch.rand(tiles, generator=gen, device=dev)]
        tables += [torch.rand(tiles, generator=gen, device=dev)
                   for _ in range(n_tables - 1)]
        return (p, *streams, *tables)
    return make


def _pack_inputs(n, tiles, grp, gen, dev):
    """The f32 send of a compressed run (what the path packs)."""
    return (torch.randn(n, generator=gen, device=dev),)


def _unpack_inputs(n, tiles, grp, gen, dev):
    return storm_ref.quantpack_ref(
        torch.randn(n, generator=gen, device=dev), grp.block)


KERNELS = {
    "storm3_step": Kernel(
        storm.storm3_step, storm_ref.storm3_step_ref, _update_inputs(2, 2),
        "src/repro/kernels/storm/kernel.py:153", "fedbioacc",
        no_library="two outputs (p - lr*m and decay*(m - g_old)) from "
        "per-tile lr and decay tables: no single PyTorch call returns both"),
    "storm3_update": Kernel(
        storm.storm3_update, storm_ref.storm3_update_ref,
        _update_inputs(3, 2), "src/repro/kernels/storm/kernel.py:127",
        "fedbioacc",
        no_library="two outputs (p - lr*m and g_new + decay*(m - g_old)) "
        "from per-tile tables: no single PyTorch call returns both"),
    "sgd3_step": Kernel(
        storm.sgd3_step, storm_ref.sgd3_step_ref, _update_inputs(1, 1),
        "src/repro/kernels/storm/kernel.py:206", "fedbio",
        library=lambda p, g, lrs, block: torch.addcmul(
            p.view(-1, block), lrs.view(-1, 1), g.view(-1, block), value=-1,
            out=torch.empty_like(p).view(-1, block))),
    "momsgd3_step": Kernel(
        storm.momsgd3_step, storm_ref.momsgd3_step_ref, _update_inputs(2, 2),
        "src/repro/kernels/storm/kernel.py:228", "fedavg",
        no_library="two outputs, the second from the first (m' = beta*m + "
        "g, then p - lr*m'): no single PyTorch call returns both"),
    "quantpack": Kernel(
        qp.quantpack_flat, storm_ref.quantpack_ref, _pack_inputs,
        "src/repro/kernels/storm/quantpack.py:50", COMPRESSED,
        "src/repro_torch/kernels/csrc/quantpack.cu",
        no_library="no single PyTorch call takes per-tile absmax scales and "
        "quantizes"),
    "quantunpack": Kernel(
        qp.quantunpack_flat, storm_ref.quantunpack_ref, _unpack_inputs,
        "src/repro/kernels/storm/quantpack.py:68", COMPRESSED,
        "src/repro_torch/kernels/csrc/quantpack.cu",
        library=lambda q, s, block: torch.mul(q.view(-1, block),
                                              s.view(-1, 1))),
}


def kernel_work(name: str, n: int, grp):
    """One launch's work over ``n`` elements of a flat group: the kernel's
    own ``work`` function (the bytes its inputs and outputs take, its
    operations), which the dry run adds up too."""
    if name in ("quantpack", "quantunpack"):
        return qp.work(name, n, grp.block)
    return storm.work(name, n, grp.dtype, block=grp.block)


def kernel_phase(groups_of: dict, dev) -> dict:
    """Per kernel: both buffers of one step of its path — the bitwise check,
    the measured kernel and plain times, and the bound from the bytes and
    operations these inputs need (each input read once, each output written
    once: the nbytes of the call's own tensors); where one PyTorch call
    computes the same function, its time too, after checking that it
    agrees bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, k in KERNELS.items():
        ms = plain_ms = lib_ms = bound_bytes = flops = 0.0
        max_err = 0.0
        for grp in groups_of[k.path]:
            n = CLIENTS * grp.padded
            tiles = n // grp.block
            args = k.inputs(n, tiles, grp, gen, dev)
            out = k.wrapper(*args, block=grp.block)
            want = k.plain(*args, grp.block)
            torch.cuda.synchronize()
            out, want = ((o,) if torch.is_tensor(o) else o for o in (out, want))
            for o, w in zip(out, want):
                if not same_bits(o, w):
                    raise SystemExit(f"{name}: kernel differs from the plain "
                                     f"version on the {grp.dtype} buffer")
                max_err = max(max_err, float((o.double() - w.double())
                                             .abs().max()))
            work = kernel_work(name, n, grp)
            moved = work.bytes
            probe = ""
            if name == "quantpack":
                x, (q, s) = args[0], out
                variant = qp.pack_variant(grp.block, x.data_ptr(),
                                          q.data_ptr())
                # the two-pass kernel past the wrapper, into fresh buffers
                # filled with what it must overwrite, then held to the plain
                # version bit for bit as the wrapper's kernel was
                q2, s2 = torch.full_like(q, 85), torch.full_like(s, -1.0)
                two = raw_ms("quantpack_tiles", qp._lib(), x.data_ptr(),
                             q2.data_ptr(), s2.data_ptr(), n, grp.block)
                if not (same_bits(q2, want[0]) and same_bits(s2, want[1])):
                    raise SystemExit(f"quantpack_tiles: differs from the "
                                     f"plain version on the {grp.dtype} "
                                     f"buffer")
                del q2, s2
                probe = (f", {variant} (cluster of "
                         f"{qp.cluster_size(grp.block)}); the two-pass "
                         f"kernel on the same inputs {two:.4f} ms, "
                         f"bitwise equal")
            del out, want
            k_ms = timed_ms(lambda: k.wrapper(*args, block=grp.block),
                            KERNEL_RUNS)
            p_ms = timed_ms(lambda: k.plain(*args, grp.block), PLAIN_RUNS)
            lib = ""
            if k.library is not None:
                if not same_bits(k.library(*args, grp.block).reshape(-1),
                                 k.wrapper(*args, block=grp.block)):
                    raise SystemExit(f"{name}: the library call differs "
                                     f"from the kernel")
                l_ms = timed_ms(lambda: k.library(*args, grp.block),
                                KERNEL_RUNS)
                lib_ms += l_ms
                lib = f", library {l_ms:.4f} ms (bitwise equal)"
            bound = max(moved / HBM_BYTES_PER_S,
                        work.flops / F32_FLOPS_PER_S) * 1e3
            log(f"{name} {str(grp.dtype).replace('torch.', '')} group "
                f"[{CLIENTS}, {grp.padded}] ({k.path} path): bitwise equal, "
                f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms{lib}, {moved} B, "
                f"bound {bound:.4f} ms ({moved / k_ms / 1e6:.1f} GB/s, "
                f"{bound / k_ms:.1%} of the bound){probe}")
            ms += k_ms
            plain_ms += p_ms
            bound_bytes += moved
            flops += work.flops
            del args
            torch.cuda.empty_cache()
        bytes_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        if k.library is None:
            log(f"{name}: library none: {k.no_library}")
        results[name] = {
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": 0, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None if k.library is None else lib_ms}
    return results


def non_finite_phase(dev) -> None:
    """Tiles holding a NaN, +Inf and -Inf and a clean tile, through each
    pack kernel: q and scales bit for bit the plain version's, and the
    reference's semantics (scales NaN, Inf, Inf, finite; q 0 at the
    non-finite elements; the three bad tiles unpack to all NaN)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    for block, start in ((65536, 0), (1024, 0), (65536, 1), (262144, 0)):
        buf = torch.randn(start + 4 * block, generator=gen, device=dev)
        x = buf[start:]
        bad = torch.tensor([3, block + 5, 2 * block + 7], device=dev)
        x[bad] = torch.tensor([math.nan, math.inf, -math.inf], device=dev)
        qp.reset_counts()
        q, s = qp.quantpack_flat(x, block=block)
        want_q, want_s = storm_ref.quantpack_ref(x, block)
        out = qp.quantunpack_flat(q, s, block=block)
        torch.cuda.synchronize()
        variant = [k for k, v in qp.VARIANTS.items() if v]
        ok = (same_bits(q, want_q) and same_bits(s, want_s)
              and same_bits(out, storm_ref.quantunpack_ref(q, s, block))
              and bool(torch.isnan(s[0])) and bool((s[1:3] == math.inf).all())
              and bool(torch.isfinite(s[3])) and not bool(q[bad].any())
              and bool(torch.isnan(out[:3 * block]).all())
              and bool(torch.isfinite(out[3 * block:]).all()))
        log(f"quantpack non-finite tiles (block {block}, start {start}, "
            f"{variant}): scales {s.tolist()}, q at the bad elements "
            f"{q[bad].tolist()}, NaN values unpacked per tile "
            f"{torch.isnan(out).view(4, block).sum(1).tolist()}: "
            f"{'as the plain version and the reference' if ok else 'WRONG'}")
        if not ok:
            raise SystemExit("quantpack: non-finite tiles differ from the "
                             "plain version or the reference's semantics")


def compression_phase(groups, dev) -> None:
    """The times of the compressed path's top-k and of its whole
    compressed reduction (top-k, pack, unpack, the client mean and the
    error feedback), on one run spanning the bf16 buffer's f32 send at its
    full shape."""
    grp = groups[0]
    cfg = flat.CompressCfg(quant="int8", topk_frac=0.1)
    gen = torch.Generator(device=dev).manual_seed(1)
    seg = torch.randn(CLIENTS, grp.padded, generator=gen, device=dev)
    eseg = 0.01 * torch.randn(CLIENTS, grp.padded, generator=gen, device=dev)
    topk_ms = timed_ms(lambda: flat._topk_tiles(seg, grp.block, 0.1), 3)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    # in place: each timed call reduces the previous call's output
    mean_ms = timed_ms(
        lambda: flat._compressed_mean_into(seg, eseg, None, cfg, grp.block),
        3)
    extra = torch.cuda.max_memory_allocated(dev) - base
    log(f"compressed reduction, f32 send [{CLIENTS}, {grp.padded}] with "
        f"error feedback, int8 + top-k 10 %: top-k {topk_ms:.4f} ms, whole "
        f"reduction {mean_ms:.4f} ms, its transient memory {extra} B")
    del seg, eseg
    torch.cuda.empty_cache()


def reductions_phase(groups_of: dict, weights: dict, dev) -> None:
    """The two reductions of the communication schedule at their paths'
    full-depth, full-width bf16 buffers, one run spanning the buffer: the
    arrival-weighted int8 + top-k mean with error feedback (round 0's
    arrivals of ``STRAGGLED_INT8``, 8 clients) and the grouped int8 mean
    (``HIERARCHICAL``'s round-1 participants, 4 clients in 2 pods).  The
    card's first call is held bit for bit (buffer rows and error feedback)
    to the same reduction on the CPU over the first ``HOST_COLUMNS``
    columns of the same input rows; then the median time over CUDA events
    of the in-place reduction, its launches and its transient memory."""
    gen = torch.Generator(device=dev).manual_seed(11)
    cases = ((STRAGGLED_INT8, "arrival-weighted int8 + top-k 10 % with "
              "error feedback", flat.CompressCfg(quant="int8",
                                                 topk_frac=0.1)),
             (HIERARCHICAL, "grouped int8, 2 pods, weighted by the round's "
              "participants", flat.CompressCfg(quant="int8")))
    for path, what, cfg in cases:
        grp, w = groups_of[path][0], weights[path]
        m, block = len(w), groups_of[path][0].block
        seg = torch.randn(m, grp.padded, generator=gen,
                          device=dev).to(grp.dtype)
        eseg = (0.01 * torch.randn(m, grp.padded, generator=gen, device=dev)
                if cfg.has_ef else None)

        def reduce(s, e, wt):
            if cfg.topk_frac > 0:
                flat._compressed_mean_into(s, e, wt, cfg, block)
            else:
                flat._compressed_mean_grouped_into(s, wt, cfg, block, 2)

        cols = min(grp.padded, HOST_COLUMNS)
        host = (seg[:, :cols].cpu(),
                None if eseg is None else eseg[:, :cols].cpu())
        reset_counts()
        reduce(seg, eseg, w)
        torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts().items() if v}
        variants = {k: v for k, v in variant_counts().items() if v}
        reduce(*host, w.cpu())
        ok = same_bits(seg[:, :cols].cpu(), host[0]) and (
            eseg is None or same_bits(eseg[:, :cols].cpu(), host[1]))
        del host
        if not ok:
            raise SystemExit(f"reduction {what} ({path} path): the card "
                             f"differs from the CPU")
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ms = timed_ms(lambda: reduce(seg, eseg, w), 5)
        extra = torch.cuda.max_memory_allocated(dev) - base
        log(f"reduction {what} ({path} path): {str(grp.dtype)[6:]} "
            f"[{m}, {grp.padded}] block {block}, weights {w.tolist()}: "
            f"card equal to the CPU bit for bit over columns [0, {cols}) "
            f"(rows{' and error feedback' if eseg is not None else ''}); "
            f"median {ms:.4f} ms over 5 calls (CUDA events, in place), "
            f"launches {launches} by kernel {variants}, transient memory "
            f"{extra} B, on {card_line()}")
        del seg, eseg
        torch.cuda.empty_cache()


# the gated launches: (kernel, the path whose buffers it is held at)
GATED = [("storm3_step", SAMPLED), ("sgd3_step", "fedbio"),
         ("momsgd3_step", "fedavg"), ("storm3_step", STRAGGLED),
         ("storm3_step", FAULTY)]


def gate_mask(run, m: int):
    """The mask phase 3 gates a path's tables with, the client whose
    gradient it fills with inf/NaN, and how the mask was chosen: on a
    straggler path round 0's launch mask as its late policy makes it from
    the round's decision, and a client that was sampled but arrived late;
    elsewhere every other client left out, and the first of them."""
    strag, faults = run.step.stragglers, run.step.faults
    if faults is not None:
        # the first faulted round whose keep mask, under the spec edited to
        # FAULT_DROPOUT, drops two clients
        edited = make_faults(faults.spec._replace(dropout_rate=FAULT_DROPOUT),
                             m)
        r = next(r for r in itertools.count(faults.spec.start_round)
                 if int((edited.round_masks(r)[0] == 0).sum()) == 2)
        keep = edited.round_masks(r)[0]
        out = [i for i in range(m) if keep[i] == 0]
        return (keep, out[0], f"round {r}'s keep mask under dropout_rate "
                f"{FAULT_DROPOUT}, clients {out} dropped")
    if strag is None:
        mask = torch.ones(m)
        mask[1::2] = 0.0
        return mask, 1, "every other client left out"
    part = run.init.participation
    sampled = torch.ones(m) if part is None else part.mask_fn(0)
    arrivals = strag.round_decision(0, sampled, strag.spec.deadline)[0]
    late = [i for i in range(m) if sampled[i] > 0 and arrivals[i] == 0]
    if not late or strag.spec.late_policy == "carry":
        raise SystemExit("gated phase: round 0 of the straggler path "
                         "freezes no late client")
    return (arrivals, late[0],
            f"round 0's arrivals ({strag.spec.late_policy}; sampled "
            f"{[i for i in range(m) if sampled[i] > 0]}, late {late})")


def gated_phase(groups_of: dict, gates: dict, dev) -> None:
    """The three update kernels with their tile tables gated by a mask that
    leaves clients out (``gate_mask``), at their path's shapes: bit for bit
    against the plain version on the same gated tables, the left-out rows
    at their input bits, and inf/NaN in a left-out client's gradient zeroed
    by ``flat.mask_buffers`` first.  The plain version runs a client row at
    a time (it is elementwise over tiles, so its bits are those of one
    call), so that its f32 temporaries fit beside 8 clients' buffers."""
    gen = torch.Generator(device=dev).manual_seed(7)
    for name, path in GATED:
        k = KERNELS[name]
        mask, nan_row, how = gates[path]
        m = len(mask)
        out_rows = [i for i in range(m) if mask[i] == 0]
        n_tables = 1 if name == "sgd3_step" else 2
        for grp in groups_of[path]:
            n = m * grp.padded
            args = k.inputs(n, n // grp.block, grp, gen, dev)
            p, streams = args[0], list(args[1:-n_tables])
            g = streams[-1].view(m, -1)
            g[nan_row, :3] = torch.tensor([math.inf, -math.inf, math.nan],
                                          device=dev)
            flat.mask_buffers((g,), mask)
            tables = [t.view(m, -1) for t in args[-n_tables:]]
            lr, rest = flat._gate(tables[0], tables[1] if n_tables == 2
                                  else None, mask, 1.0)
            tables = [t.reshape(-1) for t in (lr, rest) if t is not None]
            del args, g
            out = k.wrapper(p, *streams, *tables, block=grp.block)
            out = (out,) if torch.is_tensor(out) else out
            ok = True
            for i in range(m):
                want = k.plain(*(t.view(m, -1)[i]
                                 for t in (p, *streams, *tables)), grp.block)
                want = (want,) if torch.is_tensor(want) else want
                ok = ok and all(same_bits(o.view(m, -1)[i], w)
                                for o, w in zip(out, want))
                del want
            torch.cuda.synchronize()
            # p' and (for the momentum kernels) m' against p and m
            for o, before in zip(out, (p, streams[0])):
                rows = o.view(m, -1)[out_rows]
                ok = ok and same_bits(rows, before.view(m, -1)[out_rows])
            ok = ok and all(bool(torch.isfinite(o.float()).all())
                            for o in out)
            verdict = ("bitwise equal to the plain version, left-out rows at "
                       "their input bits" if ok else "WRONG")
            log(f"gated {name} {str(grp.dtype).replace('torch.', '')} "
                f"[{m}, {grp.padded}] ({path} path, block {grp.block}), "
                f"mask {mask.tolist()}: {how}, inf/NaN in client "
                f"{nan_row}'s gradient: {verdict}")
            if not ok:
                raise SystemExit(f"gated {name}: differs from the plain "
                                 f"version or moved a left-out row")
            del p, streams, tables, out
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3b: the pytree storm_update over a whole model's parameter tree
# ---------------------------------------------------------------------------

def _update_tree(params, m_dtype, gen):
    """Momentum (``m_dtype``) and two f32 gradient trees shaped as
    ``params``."""
    def draw(dtype):
        return tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                              device=t.device).to(dtype),
                        params)
    return draw(m_dtype), draw(torch.float32), draw(torch.float32)


def _tree_update_checked(what: str, params, mom, g_new, g_old,
                         groups: int) -> tuple:
    """One ``storm_update`` over the tree with its launches counted alone,
    every leaf held bit for bit to the plain version; returns the
    launches and the largest |p' - p_ref| and |m' - m_ref| over the
    leaves."""
    reset_counts()
    p_new, m_new = storm_update(params, mom, g_new, g_old, TREE_LR,
                                TREE_DECAY)
    torch.cuda.synchronize()
    launches = launch_counts()
    want = {**dict.fromkeys(launches, 0), "storm_update": groups}
    if launches != want:
        raise SystemExit(f"storm_update over {what} launched {launches}, "
                         f"expected {want}")
    err = 0.0
    for p, m, gn, go, pn, mn in zip(*(tree_leaves(t) for t in (
            params, mom, g_new, g_old, p_new, m_new))):
        want_p, want_m = storm_ref.storm_update_ref(
            p, m, gn.to(m.dtype), go.to(m.dtype), TREE_LR, TREE_DECAY)
        if not (same_bits(pn, want_p) and same_bits(mn, want_m)):
            raise SystemExit(f"storm_update over {what}: a leaf of shape "
                             f"{list(p.shape)} differs from the plain "
                             f"version")
        err = max(err, *(float((a.float() - b.float()).abs().max())
                         for a, b in ((pn, want_p), (mn, want_m))))
    return launches, err


def storm_update_phase(dev) -> dict:
    """The library's pytree entry point over the full-width Mamba-2-130M
    tree: f32 momentum (the path whose launches and times are reported),
    bf16 momentum, and an odd tree; then the times of the kernel over the
    f32-momentum run's concatenated groups, of its plain version, and of
    the whole entry point."""
    gen = torch.Generator(device=dev).manual_seed(4)
    params = build_model(get_config(TREE_ARCH)).init(gen)
    leaves = tree_leaves(params)
    pairs = {t.dtype for t in leaves}
    count = sum(t.numel() for t in leaves)
    mom, g_new, g_old = _update_tree(params, torch.float32, gen)
    launches, err = _tree_update_checked(f"{TREE_ARCH} (f32 momentum)",
                                         params, mom, g_new, g_old,
                                         len(pairs))
    errs = [err, _tree_update_checked(
        f"{TREE_ARCH} (bf16 momentum)", params,
        *_update_tree(params, torch.bfloat16, gen), len(pairs))[1]]
    odd = {"w": torch.randn(70001, generator=gen, device=dev).bfloat16(),
           "b": {"x": torch.randn(3, 5, generator=gen, device=dev),
                 "y": torch.randn(1, generator=gen, device=dev).bfloat16()}}
    odd_mom = {"w": torch.randn(70001, generator=gen, device=dev).bfloat16(),
               "b": {"x": torch.randn(3, 5, generator=gen, device=dev),
                     "y": torch.randn(1, generator=gen, device=dev)}}
    errs.append(_tree_update_checked(
        "an odd tree", odd, odd_mom,
        *_update_tree(odd, torch.float32, gen)[1:], 3)[1])

    # the kernel's own inputs: the f32-momentum run's groups, concatenated
    groups = {}
    for p, m, gn, go in zip(*(tree_leaves(t) for t in (params, mom, g_new,
                                                       g_old))):
        groups.setdefault((p.dtype, m.dtype), []).append((p, m, gn, go))
    bufs = [tuple(torch.cat([leaf[i].reshape(-1) for leaf in grp])
                  for i in range(4)) for grp in groups.values()]
    works = [storm.work("storm_update", b[0].numel(), b[0].dtype,
                        m_dtype=b[1].dtype) for b in bufs]
    moved = sum(w.bytes for w in works)
    group_ms = [timed_ms(lambda b=b: storm.storm_update_flat(
        *b, TREE_LR, TREE_DECAY), KERNEL_RUNS) for b in bufs]
    k_ms = sum(group_ms)
    p_ms = sum(timed_ms(lambda b=b: storm_ref.storm_update_ref(
        *b, TREE_LR, TREE_DECAY), PLAIN_RUNS) for b in bufs)
    w_ms = timed_ms(lambda: storm_update(params, mom, g_new, g_old, TREE_LR,
                                         TREE_DECAY), KERNEL_RUNS)
    sizes = [(str(p).replace("torch.", ""), str(m).replace("torch.", ""),
              sum(leaf[0].numel() for leaf in grp))
             for (p, m), grp in groups.items()]
    entry = _entry("storm_update", "src/repro_torch/kernels/csrc/storm3.cu",
                   "src/repro/kernels/storm/kernel.py:76", max(errs), k_ms,
                   p_ms, moved,
                   sum(w.flops for w in works) / F32_FLOPS_PER_S * 1e3, None)
    entry["launches"] = launches["storm_update"]
    log(f"storm_update over {TREE_ARCH} ({count} parameters in "
        f"{len(leaves)} leaves; groups (p, m, elements) {sizes}), f32 and "
        f"bf16 momentum and an odd tree: bitwise equal (max abs err "
        f"{max(errs):.3e}), "
        f"{launches['storm_update']} launches a call; kernel {k_ms:.4f} ms "
        f"(by group {[round(t, 4) for t in group_ms]}), "
        f"plain {p_ms:.4f} ms, whole entry point (concatenation and "
        f"launches) {w_ms:.4f} ms, {moved} B, bound "
        f"{entry['bound_ms']:.4f} ms by {entry['bound_by']} "
        f"({moved / k_ms / 1e6:.1f} GB/s)")
    log("storm_update: library none: no single PyTorch call computes this "
        "pair of outputs")
    del params, mom, g_new, g_old, bufs
    torch.cuda.empty_cache()
    return entry


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

def _to(state: FlatState, dev) -> FlatState:
    """``state`` with its buffers on ``dev`` (the step and the staleness
    counters stay on the host)."""
    return state._replace(vars=tuple(b.to(dev) for b in state.vars),
                          mom=tuple(b.to(dev) for b in state.mom),
                          ef=tuple(tuple(b.to(dev) for b in side)
                                   for side in state.ef))


def _recording(topk, calls: list):
    """``topk`` (``flat._topk_tiles``) that also records its input and
    output as f32 numpy arrays on the host."""
    def wrapped(x, block, frac):
        y = topk(x, block, frac)
        calls.append((x.cpu().numpy(), y.cpu().numpy()))
        return y
    return wrapped


def _rel_outside(g: torch.Tensor, c: torch.Tensor, mask) -> float:
    keep = torch.from_numpy(~mask)
    g, c = g.cpu().float()[keep], c.float()[keep]
    return float((g - c).norm() / c.norm())


def cross_check(name: str, exp: Experiment, dev, steps: int = 2) -> None:
    """``steps`` reduced steps on the card against as many on the CPU."""
    cpu_run = build(exp, device="cpu")
    gpu_run = build(exp, device=dev)
    cpu_state = cpu_run.init(torch.Generator().manual_seed(0))
    gpu_state = _to(cpu_state, dev)
    data = torch.Generator().manual_seed(1)
    calls = {"cpu": [], "gpu": []}
    metrics = {"cpu": [], "gpu": []}
    cp = exp.compression
    topk = flat._topk_tiles
    for _ in range(steps):
        batch = cpu_run.batch_fn(data)
        try:
            flat._topk_tiles = _recording(topk, calls["cpu"])
            cpu_state, met = cpu_run.step(cpu_state, batch)
            metrics["cpu"].append(met)
            flat._topk_tiles = _recording(topk, calls["gpu"])
            gpu_state, met = gpu_run.step(
                gpu_state, {k: {kk: v.to(dev) for kk, v in b.items()}
                            for k, b in batch.items()})
            metrics["gpu"].append(met)
        finally:
            flat._topk_tiles = topk
    pairs = [(g, c, None) for g, c in zip(gpu_state.vars + gpu_state.mom,
                                          cpu_state.vars + cpu_state.mom)]
    flipped = []
    if cp is not None and cp.topk_frac > 0:
        # one round over one f32 buffer: the variables, then the momenta
        if len(cpu_run.init.spec.groups) != 1 or \
                not len(calls["cpu"]) == len(calls["gpu"]) == 2:
            raise SystemExit(f"cross-check of {name}: expected the 2 "
                             f"compressed reductions of one buffer")
        pairs = []
        block = cpu_run.init.spec.groups[0].block
        sides = zip(calls["cpu"], calls["gpu"],
                    (cpu_state.vars, cpu_state.mom),
                    (gpu_state.vars, gpu_state.mom),
                    cpu_state.ef or ((), ()), gpu_state.ef or ((), ()))
        for (c_in, c_out), (g_in, g_out), cb, gb, ce, ge in sides:
            flips = topk_flips(c_in, c_out, g_in, g_out, block, cp.topk_frac)
            if cp.quant == "int8":
                flips |= int8_flips(c_out, g_out, block)
            flipped.append(int(flips.sum()))
            cols = np.broadcast_to(flips.any(axis=0), flips.shape)
            pairs += [(g, c, cols) for g, c in zip(gb, cb)]
            pairs += [(g, c, flips) for g, c in zip(ge, ce)]
    worst = 0.0
    for g, c, mask in pairs:
        if mask is None:
            rel = float((g.cpu().float() - c.float()).norm()
                        / c.float().norm())
        else:
            rel = _rel_outside(g, c, mask)
        worst = max(worst, rel)
    what = "" if not flipped else (
        f", off the {flipped} entries (variables, momenta) that top-k or "
        f"int8 rounding decided otherwise, each within its bound of the "
        f"threshold or half-way point, error feedback included")
    part = ""
    if cpu_run.init.participation is not None:
        rounds = sorted({t // exp.schedule.local_steps
                         for t in range(steps)})
        masks = [[r.mask_fn(i).tolist() for i in rounds]
                 for r in (cpu_run.init.participation,
                           gpu_run.init.participation)]
        if masks[0] != masks[1] or not torch.equal(cpu_state.stale,
                                                   gpu_state.stale):
            raise SystemExit(f"cross-check of {name}: the masks or the "
                             f"staleness counters differ between devices")
        part = (f", masks {masks[0]} and staleness counters "
                f"{cpu_state.stale.tolist()} equal on both")
    if cpu_run.step.stragglers is not None:
        # decided on the host from the step counter, the sampled mask and
        # the deadline each state carries: equal unless the deadline was
        # threaded through the card's steps otherwise
        decided = [[_decision(m) for m in metrics[side]]
                   for side in ("cpu", "gpu")]
        if decided[0] != decided[1] or not same_bits(cpu_state.deadline,
                                                     gpu_state.deadline):
            raise SystemExit(f"cross-check of {name}: the straggler "
                             f"decisions or the deadline differ between "
                             f"devices: {decided}")
        part += (f"; per step (arrivals, extensions, effective deadline, "
                 f"next deadline) {decided[0]} equal on both")
    log(f"reduced cross-check, {name}: card vs CPU after {steps} steps, worst "
        f"relative buffer difference {worst:.3e} (limit 1e-4){what}{part}")
    if not worst <= 1e-4:
        raise SystemExit(f"reduced cross-check of {name} failed")


@contextlib.contextmanager
def _recorded_sends(calls: list):
    """While open, every compressed run of ``flat`` appends ``(storage,
    start column, acc, quantizer input)`` to ``calls``: the data pointer
    of the run's buffer, where the run starts in it, the f32 (row + EF)
    and what the quantizer took (the top-k's output, or ``acc``), as host
    arrays."""
    sent, mean, grouped = (flat._compress_sent, flat._compressed_mean_into,
                           flat._compressed_mean_grouped_into)
    where = []

    def rec_sent(acc, ccfg, block):
        kept = (flat._topk_tiles(acc, block, ccfg.topk_frac)
                if ccfg.topk_frac > 0 else acc)
        # copies: on the CPU ``acc`` may be the run itself, which the
        # mean then overwrites
        calls.append((*where[-1], acc.cpu().numpy().copy(),
                      kept.cpu().numpy().copy()))
        return sent(acc, ccfg, block)

    def at(fn):
        def run(seg, *args):
            where.append((seg.untyped_storage().data_ptr(),
                          seg.storage_offset()))
            return fn(seg, *args)
        return run

    flat._compress_sent = rec_sent
    flat._compressed_mean_into = at(mean)
    flat._compressed_mean_grouped_into = at(grouped)
    try:
        yield
    finally:
        flat._compress_sent, flat._compressed_mean_into = sent, mean
        flat._compressed_mean_grouped_into = grouped


def _buffer_names(state: FlatState) -> dict:
    """Storage pointer → ("vars" | "mom", dtype group) of a state's
    buffers (the reductions write into the buffers the step returns)."""
    return {b.untyped_storage().data_ptr(): (side, g)
            for side, bufs in (("vars", state.vars), ("mom", state.mom))
            for g, b in enumerate(bufs)}


def round_cross_check(name: str, exp: Experiment, dev) -> None:
    """Two rounds of a compressed path with participation or stragglers,
    reduced, card against CPU, round by round: each round starts both
    devices from the CPU's state, runs its local steps on the same batches
    and compares.  Every entry that top-k or int8 rounding decided
    otherwise on the two devices must lie within its bound of the
    threshold or half-way point (``topk_flips``, ``int8_flips``, each
    compressed run mapped back to its buffer columns); the variables and
    momenta within 1e-4 of each buffer's norm off the columns those flips
    reach, the error feedback off the flipped entries; each round's
    participation mask, arrivals and staleness counters equal on both."""
    exp = exp.edit(**{"schedule.steps": 2 * exp.schedule.local_steps})
    cpu_run = build(exp, device="cpu")
    gpu_run = build(exp, device=dev)
    cp, local = exp.compression, exp.schedule.local_steps
    cpu_state = cpu_run.init(torch.Generator().manual_seed(0))
    data = torch.Generator().manual_seed(1)
    worst, flipped, rounds = 0.0, [], []
    for r in range(2):
        gpu_state = _to(cpu_state, dev)
        calls = {"cpu": [], "gpu": []}
        names = {"cpu": {}, "gpu": {}}
        decided = {"cpu": [], "gpu": []}
        for _ in range(local):
            batch = cpu_run.batch_fn(data)
            with _recorded_sends(calls["cpu"]):
                cpu_state, met = cpu_run.step(cpu_state, batch)
            names["cpu"].update(_buffer_names(cpu_state))
            decided["cpu"].append(met.get("decision"))
            with _recorded_sends(calls["gpu"]):
                gpu_state, met = gpu_run.step(
                    gpu_state, {k: {kk: v.to(dev) for kk, v in b.items()}
                                for k, b in batch.items()})
            names["gpu"].update(_buffer_names(gpu_state))
            decided["gpu"].append(met.get("decision"))
        if len(calls["cpu"]) != len(calls["gpu"]) or not calls["cpu"]:
            raise SystemExit(f"cross-check of {name}: round {r + 1} ran "
                             f"{len(calls['cpu'])} compressed runs on the "
                             f"CPU and {len(calls['gpu'])} on the card")
        block = cpu_run.init.spec.groups[0].block
        masks = {}
        for (cs, c0, c_acc, c_in), (gs, g0, g_acc, g_in) in zip(
                calls["cpu"], calls["gpu"]):
            where = names["cpu"][cs]
            if (where, c0) != (names["gpu"][gs], g0):
                raise SystemExit(f"cross-check of {name}: the devices ran "
                                 f"their compressed runs in another order")
            flips = np.zeros(c_acc.shape, bool)
            if cp.topk_frac > 0:
                flips |= topk_flips(c_acc, c_in, g_acc, g_in, block,
                                    cp.topk_frac)
            if cp.quant == "int8":
                flips |= int8_flips(c_in, g_in, block)
            buf = getattr(cpu_state, where[0])[where[1]]
            mask = masks.setdefault(where, np.zeros(tuple(buf.shape), bool))
            mask[:, c0:c0 + flips.shape[1]] |= flips
        flipped.append(int(sum(m.sum() for m in masks.values())))
        pairs = []
        for side in ("vars", "mom"):
            for g, (gb, cb) in enumerate(zip(getattr(gpu_state, side),
                                             getattr(cpu_state, side))):
                mask = masks.get((side, g))
                cols = (None if mask is None else
                        np.broadcast_to(mask.any(axis=0), mask.shape))
                pairs.append((gb, cb, cols))
                if cpu_state.ef:
                    k = 0 if side == "vars" else 1
                    pairs.append((gpu_state.ef[k][g], cpu_state.ef[k][g],
                                  mask))
        for g, c, mask in pairs:
            if mask is None:
                rel = float((g.cpu().float() - c.float()).norm()
                            / c.float().norm())
            else:
                rel = _rel_outside(g, c, mask)
            worst = max(worst, rel)
        part = cpu_run.init.participation
        same = (torch.equal(cpu_state.stale, gpu_state.stale)
                and part.mask_fn(r).tolist()
                == gpu_run.init.participation.mask_fn(r).tolist())
        if cpu_run.step.stragglers is not None:
            same = same and ([_decision({"decision": d})
                              for d in decided["cpu"]]
                             == [_decision({"decision": d})
                                 for d in decided["gpu"]])
        if not same:
            raise SystemExit(f"cross-check of {name}: round {r + 1}'s mask, "
                             f"arrivals or staleness counters differ between "
                             f"devices")
        rounds.append((part.mask_fn(r).tolist(),
                       decided["cpu"][-1]["arrivals"].tolist()
                       if decided["cpu"][-1] else None,
                       cpu_state.stale.tolist()))
    log(f"reduced cross-check, {name}: card vs CPU, 2 rounds of {local} "
        f"steps each from the CPU's state, worst relative buffer difference "
        f"{worst:.3e} (limit 1e-4) off the {flipped} entries (per round) "
        f"that top-k or int8 rounding decided otherwise, each within its "
        f"bound, error feedback included; per round (mask, arrivals, "
        f"staleness counters) {rounds} equal on both")
    if not worst <= 1e-4:
        raise SystemExit(f"reduced cross-check of {name} failed")


def _rows_equal(buf: torch.Tensor, rows: list) -> bool:
    return all(same_bits(buf[rows[0]], buf[r]) for r in rows[1:])


def _state_rows(state: FlatState) -> tuple:
    """The [M, N] buffers whose non-participant rows a step must leave at
    their entering bits: variables, momenta and error feedback."""
    return state.vars + state.mom + sum(state.ef, ())


def _participation_checks(name: str, run, state: FlatState, kept, out: list,
                          ins: list, round_end: bool) -> None:
    """After a step of a sampled path: the rows ``out`` that the launch
    mask left out at their entering bits (``kept``: per buffer of
    ``_state_rows``, client → its row on the host); after a round, the
    rows ``ins`` that entered the mean, section by section as the schedule
    has it: bit-identical where the round reduced the section in full;
    within each pod and not across pods at a pod-local round of a
    HIERARCHICAL section; not where the section is private or its cadence
    skipped the round."""
    for b, rows in zip(_state_rows(state), kept):
        if not all(same_bits(b[i].cpu(), rows[i]) for i in out):
            raise SystemExit(f"path {name}: a non-participant's row moved")
    if not round_end:
        return
    spec, fed = run.init.spec, run.fed
    r = state.step // fed.local_steps
    local = fed.hierarchy_period > 0 and r % fed.hierarchy_period
    size = state.vars[0].shape[0] // fed.hierarchy_groups
    pods = [[i for i in ins if i // size == g]
            for g in range(fed.hierarchy_groups)]
    heads = [p[0] for p in pods if p]
    for side, bufs in (("variables", state.vars), ("momenta", state.mom)):
        for s, sec in enumerate(spec.sections):
            # the section's columns in every dtype buffer: int8 sends can
            # make a small buffer's rows equal everywhere (its tile's scale
            # swamps the clients' differences), so "differ" is asked of the
            # section as a whole
            segs = [buf[:, a:b] for grp, buf in zip(spec.groups, bufs)
                    for t, a, b in grp.extents if t == s]

            def equal(rows):
                return all(_rows_equal(seg, rows) for seg in segs)

            def distinct(rows):
                return all(not equal([i, j]) for i, j in
                           itertools.combinations(rows, 2))

            q = run.step.aspec.sequences[s]
            if q.comm == seqs.PRIVATE or r % q.comm_every:
                want = "no two participants' rows equal"
                ok = distinct(ins)
            elif local and q.comm == seqs.HIERARCHICAL:
                want = (f"each pod's participants' rows equal and the "
                        f"pods' ({heads}) not")
                ok = all(equal(p) for p in pods if p) and distinct(heads)
            else:
                want = "every participant's rows equal"
                ok = equal(ins)
            if not ok:
                same = [[same_bits(g[ins[0]], g[i]) for i in ins]
                        for g in segs]
                raise SystemExit(
                    f"path {name}: after round {r} the {side}' section "
                    f"{sec}: expected {want}; participants {ins}, pods "
                    f"{pods}, rows equal to the first participant's, by "
                    f"buffer {same}")


def _timed_oracles(over_clients, events: list):
    """``trainer._over_clients`` whose per-client oracle calls also append
    ``(client, start, end)`` to ``events``: two CUDA events recorded on the
    current stream around the call, with no synchronization, so that the
    step's own time is untouched (the loop visits the clients in order,
    once each a pass)."""
    def timed(oracle):
        calls = [itertools.count()]

        def one(v, batch):
            i = next(calls[0])
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = oracle(v, batch)
            end.record()
            events.append((i, start, end))
            return out

        inner = over_clients(one)

        def voracle(v, batch):
            calls[0] = itertools.count()    # a pass visits clients 0..M-1
            return inner(v, batch)
        return voracle
    return timed


def _straggler_report(name: str, strag, part, rounds: list,
                      shares: list) -> None:
    """Log the straggler path's rounds beside ``simulate_rounds``' replay
    and check them against it: arrivals make quorum; each round's arrival
    count, quorum, extensions and effective deadline are the replay's; and
    the arrivals are exactly the sampled clients whose drawn time
    (``round_times``) is within that deadline."""
    rows = simulate_rounds(strag, part, len(rounds))
    for rd, row in zip(rounds, rows):
        log(f"path {name}: round {rd['round']} sampled {rd['sampled']}, "
            f"arrivals {rd['arrived']}, quorum {rd['quorum']}, extensions "
            f"{rd['extensions']}, effective deadline {rd['deadline']}, next "
            f"deadline {rd['deadline_next']}; simulated round clock "
            f"{row['wall_clock']} s against {row['wait_for_slowest']} s for "
            f"the synchronous barrier (host arithmetic, simulated seconds)")
        if len(rd["arrived"]) < rd["quorum"]:
            raise SystemExit(f"path {name}: round {rd['round']} missed its "
                             f"quorum")
        times = strag.round_times(rd["round"])
        beat = [i for i in rd["sampled"]
                if times[i] <= torch.tensor(rd["deadline"])]
        if (len(rd["arrived"]), rd["quorum"], rd["extensions"],
                round(rd["deadline"], 6)) != (row["arrivals"], row["quorum"],
                                              row["extensions"],
                                              row["deadline"]) \
                or rd["arrived"] != beat:
            raise SystemExit(f"path {name}: round {rd['round']} differs "
                             f"from simulate_rounds: {rd} vs {row}, the "
                             f"sampled clients within its deadline {beat}")
    log(f"path {name}: simulated clock over {len(rows)} rounds "
        f"{sum(r['wall_clock'] for r in rows)} s elastic against "
        f"{sum(r['wait_for_slowest'] for r in rows)} s synchronous; share "
        f"of each step's time in the oracles of (late, unsampled) clients "
        f"{shares} (each client's oracle between two CUDA events on the "
        f"card's stream)")


# ---------------------------------------------------------------------------
# phase 4 (end): the train CLI crashed and resumed; phase 5 (end): the
# full-width straggler path resumed from its checkpoint
# ---------------------------------------------------------------------------

def _cli(args: list, code: int = 0) -> tuple:
    """``python -m repro_torch.launch.train *args`` in a subprocess from the
    checkout; checks its exit code and returns (its step lines without
    ``wall_s``, its standard output and error)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    if out.returncode != code:
        raise SystemExit(f"train CLI {args} exited {out.returncode}, "
                         f"expected {code}:\n{out.stdout[-2000:]}\n"
                         f"{out.stderr[-4000:]}")
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith('{"step"')]
    for ln in lines:
        del ln["wall_s"]
    return lines, out.stdout + out.stderr


def _final_arrays(d: str) -> list:
    name = f"arrays-{checkpoint_metadata(d)['step']:08d}.npz"
    with np.load(os.path.join(d, name)) as data:
        return [data[f"a{i}"].copy() for i in range(len(data.files))]


def cli_resume_phase() -> None:
    """The reduced straggler spec through the train CLI on the card: a run
    hard-exits after its step-2 checkpoint (exit 17); ``--resume`` on the
    card must end as the uninterrupted run does, bit for bit (every logged
    loss, arrival set and deadline; every array of the final checkpoint);
    the same checkpoint resumed with ``--device cpu`` must end within 1e-4
    of each float buffer's norm, with equal arrivals, deadlines, step and
    staleness counters."""
    spec = os.path.join(ROOT, "experiments", f"{STRAGGLED}.json")
    common = ["--ckpt-every", "2", "--log-every", "1"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        crashed, cpu_dir, whole = (os.path.join(tmp, d)
                                   for d in ("crashed", "cpu", "whole"))
        first, out = _cli(["--experiment", spec, "--ckpt-dir", crashed,
                           "--crash-at-step", "2", *common], code=17)
        shutil.copytree(crashed, cpu_dir)
        resumed, out = _cli(["--resume", crashed, "--ckpt-dir", crashed,
                             *common])
        if f"resumed from {crashed} @ step 2" not in out:
            raise SystemExit("train CLI: no resume banner")
        full, _ = _cli(["--experiment", spec, "--ckpt-dir", whole, *common])
        on_cpu, _ = _cli(["--resume", cpu_dir, "--ckpt-dir", cpu_dir,
                          "--device", "cpu", *common])
        if first != full[:2] or resumed != full[2:]:
            raise SystemExit(f"train CLI: the resumed run's lines differ "
                             f"from the uninterrupted run's: {first} + "
                             f"{resumed} vs {full}")
        got, want, cpu = (_final_arrays(d) for d in (crashed, whole, cpu_dir))
        if len(got) != len(want) or not all(
                a.dtype == b.dtype and np.array_equal(
                    a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))
                for a, b in zip(got, want)):
            raise SystemExit("train CLI: the resumed run's final checkpoint "
                             "differs from the uninterrupted run's")
        # vars, mom (relative); step, stale, deadline (equal)
        worst = max(float(np.linalg.norm(c - w) / np.linalg.norm(w))
                    for c, w in zip(cpu[:2], want[:2]))
        decided = [(ln["arrivals"], ln["deadline"]) for ln in on_cpu]
        if decided != [(ln["arrivals"], ln["deadline"]) for ln in full[2:]] \
                or not all(np.array_equal(c, w)
                           for c, w in zip(cpu[2:], want[2:])):
            raise SystemExit(f"train CLI: resumed on the CPU, the arrivals, "
                             f"deadlines, step or staleness counters differ: "
                             f"{on_cpu} vs {full[2:]}")
        loss = max(abs(c["val_loss"] - w["val_loss"]) / abs(w["val_loss"])
                   for c, w in zip(on_cpu, full[2:]))
    log(f"train CLI, {STRAGGLED}: crashed after the step-2 checkpoint (exit "
        f"17), resumed on the card: steps 3-{full[-1]['step']} (val_loss, "
        f"arrivals, deadline) and the final checkpoint's {len(want)} arrays "
        f"bit for bit the uninterrupted run's; resumed on the CPU: worst "
        f"relative buffer difference {worst:.3e} (limit 1e-4), val_loss "
        f"within {loss:.3e}, arrivals, deadlines, step and staleness "
        f"counters equal; {time.perf_counter() - t0:.1f} s for 4 runs")
    if not worst <= 1e-4:
        raise SystemExit("train CLI: the CPU resume is off the card's run")


def _spread(run, state: FlatState, batch, after: FlatState) -> list:
    """Each buffer's relative response of the step of ``run`` from
    ``state`` (which led to ``after``) to a 1e-7 relative change of the
    entering variables: the step's conditioning, how far two devices'
    last-bit differences can carry."""
    b, _ = run.step(state._replace(vars=tuple(v * (1 + 1e-7)
                                              for v in state.vars)), batch)
    return [float((x.float() - y.float()).norm() / x.float().norm())
            for x, y in zip(after.vars + after.mom, b.vars + b.mom)]


def _fault_decisions(metrics) -> tuple:
    dec = metrics["decision"]
    return (tuple(m.tolist() for m in dec["faults"]),
            [v.tolist() for v in dec.get("health", [])])


def _capturing(orig, captured: list):
    """``flat._robust_mean_into`` that also keeps each call's input and
    output rows on the host, with its weights, faults and policy."""
    def capture(seg, w, corrupt, rob, verdicts=None):
        x0 = seg.cpu()
        orig(seg, w, corrupt, rob, verdicts)
        captured.append((x0, seg.cpu(), w, corrupt, rob))
    return capture


def fault_cross_check(name: str, exp: Experiment, dev) -> None:
    """The reduced faulty spec over two rounds, card against CPU: each
    step's fault masks and health verdicts equal on both devices; every
    buffer within 1e-4 of its norm after every step but the last.  The
    last step's oracles run at an aggregate that the byzantine rows left
    far off, where a 1e-7 relative change of the variables can move the
    momenta by per cents or more (the CPU's own response, measured here):
    a buffer whose response exceeds ``ILL_CONDITIONED`` is only logged,
    every other one held to 1e-4, and each guarded reduction the card ran
    in that step is rerun on the CPU on the card's input rows and held to
    1e-4.  Without robustness both devices' states must go non-finite."""
    steps = 2 * exp.schedule.local_steps
    cpu_run, gpu_run = build(exp, device="cpu"), build(exp, device=dev)
    cpu_state = cpu_run.init(torch.Generator().manual_seed(0))
    gpu_state = _to(cpu_state, dev)
    data = torch.Generator().manual_seed(1)
    rounds, spread, captured = [], None, []
    orig = flat._robust_mean_into
    for t in range(steps):
        batch = cpu_run.batch_fn(data)
        last = t == steps - 1 and exp.robustness is not None
        before = cpu_state
        cpu_state, cm = cpu_run.step(cpu_state, batch)
        if last:
            spread = _spread(cpu_run, before, batch, cpu_state)
        del before
        if last:
            flat._robust_mean_into = _capturing(orig, captured)
        try:
            gpu_state, gm = gpu_run.step(
                gpu_state, {k: {kk: v.to(dev) for kk, v in b.items()}
                            for k, b in batch.items()})
        finally:
            flat._robust_mean_into = orig
        if t < steps - 1 and exp.robustness is not None:
            early = [float((g.cpu().float() - c.float()).norm()
                           / c.float().norm()) for g, c in
                     zip(gpu_state.vars + gpu_state.mom,
                         cpu_state.vars + cpu_state.mom)]
            if not max(early) <= 1e-4:
                raise SystemExit(f"cross-check of {name}: step {t + 1}'s "
                                 f"buffers differ by {early} (limit 1e-4)")
        decided = [_fault_decisions(m) for m in (cm, gm)]
        if decided[0] != decided[1]:
            raise SystemExit(f"cross-check of {name}: step {t + 1}'s fault "
                             f"masks or verdicts differ between devices: "
                             f"{decided}")
        if (t + 1) % exp.schedule.local_steps == 0:
            (_, nan, byz), verdicts = decided[0]
            rounds.append({"round": t // exp.schedule.local_steps,
                           "nan": [i for i, v in enumerate(nan) if v],
                           "byzantine": [i for i, v in enumerate(byz) if v],
                           "screened": cm["decision"].get("screened")})
    pairs = list(zip(gpu_state.vars + gpu_state.mom,
                     cpu_state.vars + cpu_state.mom))
    if exp.robustness is None:
        finite = [all(bool(torch.isfinite(b).all()) for b in side)
                  for side in ((g for g, _ in pairs), (c for _, c in pairs))]
        log(f"reduced cross-check, {name}: card and CPU after {steps} steps, "
            f"rounds {rounds}, state finite (card, CPU) {finite}: the "
            f"unguarded mean is poisoned on both")
        if any(finite):
            raise SystemExit(f"cross-check of {name}: the unguarded run "
                             f"stayed finite")
        return
    held = [sp <= ILL_CONDITIONED for sp in spread]
    rels = [float((g.cpu().float() - c.float()).norm() / c.float().norm())
            for g, c in pairs]
    reduced = []
    for x0, out, w, corrupt, rob in captured:
        orig(x0, w, corrupt, rob)
        reduced.append(float((out.float() - x0.float()).norm()
                             / x0.float().norm()))
    log(f"reduced cross-check, {name}: card vs CPU after {steps} steps, "
        f"rounds {rounds}, masks and verdicts equal at every step, every "
        f"buffer within 1e-4 until the last step; after it relative buffer "
        f"differences {[f'{r:.3e}' for r in rels]}, the CPU's response of "
        f"the last step to a 1e-7 relative change of the variables "
        f"{[f'{x:.3e}' for x in spread]}, so held at 1e-4: {held}; the last "
        f"step's {len(reduced)} guarded reductions rerun on the CPU on the "
        f"card's inputs: {[f'{r:.3e}' for r in reduced]} (limit 1e-4)")
    if not (all(r <= 1e-4 for r, h in zip(rels, held) if h)
            and all(held[:len(gpu_state.vars)]) and len(reduced) >= 2
            and all(r <= 1e-4 for r in reduced)):
        raise SystemExit(f"reduced cross-check of {name} failed")


def cli_fault_phase() -> None:
    """The train CLI on the card with faults: a spec edited so that every
    retry of round 1 sends NaN unscreened must roll back twice to step 2,
    write ``<ckpt-dir>/diagnostic`` and exit non-zero naming round 4; the
    committed spec under ``--max-restarts 1 --crash-at-step 2`` must exit
    0 and end bit for bit as the uninterrupted run: every logged line,
    every array of the final checkpoint, ``retries``.  Every run is a
    subprocess, so that the check can run beside this process's own."""
    spec = os.path.join(ROOT, "experiments", f"{FAULTY}.json")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_faults_") as tmp:
        forced, ck = os.path.join(tmp, "forced.json"), os.path.join(tmp, "f")
        Experiment.load(spec).edit(**{
            "faults.nan_rate": 1.0, "faults.start_round": 1,
            "robustness.screen": False,
            "robustness.retry_budget": 2}).save(forced)
        _, out = _cli(["--experiment", forced, "--ckpt-dir", ck,
                       "--log-every", "2"], code=1)
        rolled = [json.loads(ln) for ln in out.splitlines()
                  if ln.startswith('{"rollback_to"')]
        if [(r["rollback_to"], r["retry"]) for r in rolled] != \
                [(2, 1), (2, 2)] or "round 4: eval loss" not in out or \
                not os.path.isfile(os.path.join(ck, "diagnostic",
                                                "manifest.json")):
            raise SystemExit(f"train CLI, forced rollbacks: {rolled}\n"
                             f"{out[-3000:]}")
        sup, whole = os.path.join(tmp, "sup"), os.path.join(tmp, "whole")
        common = ["--experiment", spec, "--ckpt-every", "2", "--log-every",
                  "1"]
        lines, out = _cli(common + ["--ckpt-dir", sup, "--max-restarts", "1",
                                    "--restart-backoff", "0",
                                    "--crash-at-step", "2"])
        if "crash-at-step: hard exit after step 2" not in out or \
                f"resumed from {sup} @ step 2" not in out:
            raise SystemExit(f"train CLI, supervisor: no crash or no "
                             f"resume:\n{out[-3000:]}")
        full, _ = _cli(common + ["--ckpt-dir", whole])
        got, want = _final_arrays(sup), _final_arrays(whole)
        md = (checkpoint_metadata(sup), checkpoint_metadata(whole))
        if lines != full or md[0] != md[1] or len(got) != len(want) or \
                not all(a.dtype == b.dtype and np.array_equal(
                    a.reshape(-1).view(np.uint8),
                    b.reshape(-1).view(np.uint8))
                    for a, b in zip(got, want)):
            raise SystemExit(f"train CLI, supervisor: the restarted run "
                             f"differs from the uninterrupted one: {lines} "
                             f"vs {full}; {md}")
    steps = [(r["rollback_to"], r["retry"]) for r in rolled]
    log(f"train CLI, {FAULTY}: with every retry of round 1 sending NaN "
        f"unscreened, rollbacks {steps} (to step, retry), then exit 1 "
        f"naming round 4 and a diagnostic checkpoint; --max-restarts 1 "
        f"--crash-at-step 2: crashed, resumed by the supervisor, steps "
        f"1-{full[-1]['step']} (val_loss, nan, byzantine, screened) {full} "
        f"and the final checkpoint's {len(want)} arrays bit for bit the "
        f"uninterrupted run's, retries {md[0]['retries']}; "
        f"{time.perf_counter() - t0:.1f} s for 4 runs")


def _decision(metrics) -> tuple:
    """A straggler step's recorded decision (the engine's record):
    (arrivals mask, extensions, effective deadline, next deadline)."""
    dec = metrics["decision"]
    return (dec["arrivals"].tolist(), dec["extensions"], dec["deadline"],
            dec["deadline_next"])


def _state_bytes(state: FlatState) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(state)
               if torch.is_tensor(t))


def _inband_is_decision(name: str, t: int, metrics, dec) -> None:
    """The straggler path's in-band ``stragglers`` group (the telemetry
    metrics the event stream reads) against the decision the engine
    recorded for the step: the same deadlines, arrival count, quorum and
    extensions."""
    if "deadline" not in metrics:
        raise SystemExit(f"path {name}: step {t + 1} carries no in-band "
                         f"straggler metrics")
    inband = (float(metrics["deadline"]), float(metrics["deadline_next"]),
              int(metrics["arrivals"]), int(metrics["quorum"]),
              int(metrics["extensions"]))
    recorded = (dec["deadline"], dec["deadline_next"],
                int(dec["arrivals"].sum()), dec["quorum"], dec["extensions"])
    if inband != recorded:
        raise SystemExit(f"path {name}: step {t + 1}'s in-band straggler "
                         f"metrics {inband} differ from its recorded "
                         f"decision {recorded}")


def save_full_width(run, state: FlatState) -> tuple:
    """Checkpoint the path's state into a fresh directory, after checking
    that it has room for twice the state (the old and the new arrays file
    coexist until the prune); returns (directory, seconds, arrays bytes)."""
    need = 2 * _state_bytes(state)
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free = shutil.disk_usage(d).free
    if free < need:
        shutil.rmtree(d)
        raise SystemExit(f"checkpoint: {d} has {free} B free, {need - free} "
                         f"B short of twice the state's {need // 2} B")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(d, state, {"step": state.step,
                               "arch": run.model_cfg.name, "retries": 0},
                    experiment=run.spec)
    secs = time.perf_counter() - t0
    size = os.path.getsize(os.path.join(d, f"arrays-{state.step:08d}.npz"))
    return d, secs, size


def resume_full_width(name: str, run, final: dict, ckpt: tuple, batches,
                      decided: list, dev) -> dict:
    """Rebuild the path from the checkpoint's embedded spec, load the
    checkpoint into the new run's initial state on the card, run the
    remaining steps on the same batches, and hold the end to the
    uninterrupted run's (``final``: its buffers on the host, step,
    staleness counters and deadline): every buffer bit for bit, every
    step's decision equal, ``storm3_step`` once per buffer a step and no
    other kernel.  Returns the resumed steps' launches."""
    d, save_s, size = ckpt
    exp2 = load_experiment(d)
    if exp2 != run.spec:
        raise SystemExit(f"path {name}: the checkpoint's spec differs")
    run2 = build(exp2, device=dev)
    like = run2.init(torch.Generator(device=dev)
                     .manual_seed(exp2.schedule.seed))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = load_checkpoint(d, like)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del like
    shutil.rmtree(d)
    if state.step != RESUME_AT:
        raise SystemExit(f"path {name}: resumed at step {state.step}")
    reset_counts()
    got, step_ms = [], []
    for batch in batches[RESUME_AT:]:
        t0 = time.perf_counter()
        state, metrics = run2.step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        got.append(_decision(metrics))
    launches = launch_counts()
    bufs = state.vars + state.mom
    want = {**dict.fromkeys(launches, 0),
            "storm3_step": len(state.vars) * len(got)}
    if launches != want:
        raise SystemExit(f"path {name} resumed launched {launches}, "
                         f"expected {want}")
    if got != decided[RESUME_AT:]:
        raise SystemExit(f"path {name}: the resumed steps decided {got}, "
                         f"the uninterrupted run {decided[RESUME_AT:]}")
    if not (state.step == final["step"]
            and torch.equal(state.stale, final["stale"])
            and same_bits(state.deadline, final["deadline"])
            and len(bufs) == len(final["bufs"])
            and all(same_bits(b.cpu(), f)
                    for b, f in zip(bufs, final["bufs"]))):
        raise SystemExit(f"path {name}: the resumed run's state differs "
                         f"from the uninterrupted run's")
    n_bytes = sum(f.numel() * f.element_size() for f in final["bufs"])
    log(f"path {name}: checkpoint after step {RESUME_AT}: {size} B arrays "
        f"file ({n_bytes} B of buffers: "
        f"{[f'{str(f.dtype)[6:]}{list(f.shape)}' for f in final['bufs']]}), "
        f"saved in {save_s:.3f} s (host copy, npz, sha256), loaded in "
        f"{load_s:.3f} s (sha256, npz, copy to the card), on {card_line()}; "
        f"resumed from a fresh build of the embedded spec: steps "
        f"{RESUME_AT + 1}-{final['step']} in "
        f"{[round(t, 3) for t in step_ms]} ms, decisions {got} and every "
        f"buffer, the step, staleness counters and deadline bit for bit the "
        f"uninterrupted run's; launches {launches}")
    return launches


def _host_available() -> int:
    """Bytes of host memory available to new allocations (``MemAvailable``
    of ``/proc/meminfo``)."""
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise SystemExit("/proc/meminfo has no MemAvailable line")


def _screen_from_scratch(seg, w, corrupt, robust) -> tuple:
    """The reference's health screen recomputed apart from the port's
    reduction, on the card: each client's row as sent (scaled in its dtype
    if byzantine, NaN if corrupted, as it is if the client sends nothing),
    its finiteness and its norm (the squares in f32, as the rule takes
    them, so that a row beyond 1.8e19 squares to inf; summed in f64), then
    ``_health_mask``'s rule.  Returns (verdict, the least margin
    ``||n − mu| − tol| / tol``, inf where an infinite norm decides every
    verdict)."""
    nan, byz, scale = corrupt
    m = seg.shape[0]
    sends = [w is None or float(w[i]) > 0 for i in range(m)]
    norms, finite = [], []
    for i in range(m):
        row = seg[i]
        if sends[i] and byz[i] > 0:
            row = row * torch.tensor(scale, dtype=row.dtype, device=row.device)
        ok = not (sends[i] and nan[i] > 0) and bool(torch.isfinite(row).all())
        finite.append(ok)
        sq = torch.sum(row.float().square(), dtype=torch.float64)
        norms.append(float(sq.to(torch.float32).sqrt()) if ok else 0.0)
    h = [s and f for s, f in zip(sends, finite)]
    n = [v if ok else 0.0 for v, ok in zip(norms, h)]
    cnt = max(sum(h), 1)
    mu = sum(v for v, ok in zip(n, h) if ok) / cnt
    sd = math.sqrt(sum((v - mu) ** 2 for v, ok in zip(n, h) if ok) / cnt)
    tol = robust.z_thresh * sd + 1e-4 * mu + 1e-12
    verdict = [float(ok and abs(v - mu) <= tol) for v, ok in zip(n, h)]
    margin = min((abs(abs(v - mu) - tol) / tol for v, ok in zip(n, h) if ok),
                 default=math.inf) if math.isfinite(tol) else math.inf
    return verdict, margin


def faulty_path(name: str, exp: Experiment, dev) -> dict:
    """The full-width faulty path driven as the train CLI drives it with
    ``--log-every 2``: a ``RollbackGuard`` observes the validation loss at
    the reference's log steps and keeps host snapshots.  Each guarded
    reduction's verdict is held to the screen recomputed from scratch
    (``_screen_from_scratch``) and timed between two CUDA events; after
    step 4 a non-finite loss is observed in place of the real one, the
    rollback must restore the step-2 snapshot bit for bit into the live
    tensors and set ``retry`` to 1, and round 1 is rerun on its
    ``(round, retry=1)`` masks.  Returns the launches of all six steps."""
    run = build(exp, device=dev)
    faults, robust = run.step.faults, exp.robustness
    state = run.init(torch.Generator(device=dev)
                     .manual_seed(exp.schedule.seed))
    data = torch.Generator().manual_seed(exp.schedule.seed)
    ring_bytes = robust.ring * _state_bytes(state)
    free = _host_available()
    if free < ring_bytes:
        raise SystemExit(f"path {name}: the host has {free} B available, "
                         f"{ring_bytes - free} B short of the rollback "
                         f"ring's {ring_bytes} B ({robust.ring} snapshots)")
    guard = RollbackGuard(robust)
    calls = []
    orig = flat._robust_mean_into

    def checked(seg, w, corrupt, rob, verdicts=None):
        want, margin = _screen_from_scratch(seg, w, corrupt, rob)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        got = []
        start.record()
        orig(seg, w, corrupt, rob, got)
        end.record()
        if got[0].tolist() != want:
            raise SystemExit(f"path {name}: the screen decided "
                             f"{got[0].tolist()}, recomputed from scratch "
                             f"{want}")
        verdicts.extend(got)
        calls.append((margin, start, end))

    local, steps = exp.schedule.local_steps, exp.schedule.steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    flat._robust_mean_into = checked
    step_ms, shares, rounds, snap_s, margins = [], [], [], [], []
    restore = None
    t = 0
    forced = False
    try:
        while t < steps:
            n_calls = len(calls)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = run.step(state, run.batch_fn(data))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            shares.append(round(sum(s.elapsed_time(e) for _, s, e in
                                    calls[n_calls:]) / step_ms[-1], 4))
            margins += [mg for mg, _, _ in calls[n_calls:]]
            t += 1
            if t % local == 0:
                if not all(bool(torch.isfinite(b).all())
                           for b in state.vars + state.mom):
                    raise SystemExit(f"path {name}: round {t // local - 1} "
                                     f"left a non-finite state")
                keep, nan, byz = metrics["decision"]["faults"]
                rounds.append({"round": t // local - 1,
                               "retry": int(state.retry),
                               "nan": nan.nonzero().flatten().tolist(),
                               "byzantine": byz.nonzero().flatten().tolist(),
                               "screened": metrics["decision"]["screened"]})
            if not (t % FAULT_LOG_EVERY == 0 or t == 1):
                continue
            loss = run.eval_fn(state)
            if t == steps and not forced:
                forced, real = True, loss
                loss = math.nan
                snap = guard._good[-1]
                ptrs = [b.data_ptr() for b in state.vars + state.mom]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rb = guard.observe(t, state, data, loss)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if rb is None:
                snap_s.append(round(secs, 3))
                continue
            t, state, _ = rb
            # no name may hold this state past the next step, or the card
            # holds two
            del rb
            if not (t == snap[0] == local and int(state.retry) == 1
                    and [b.data_ptr() for b in state.vars + state.mom] == ptrs
                    and all(same_bits(b.cpu(), h) for b, h in
                            zip(state.vars + state.mom,
                                snap[1].vars + snap[1].mom))):
                raise SystemExit(f"path {name}: the rollback to step {t} did "
                                 f"not restore the snapshot in place")
            restore = (round(secs, 3), real)
    finally:
        flat._robust_mean_into = orig
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    rerun = faults.round_masks(1, 1)
    if rounds[-1]["retry"] != 1 or \
            [rounds[-1]["nan"], rounds[-1]["byzantine"]] != \
            [rerun[1].nonzero().flatten().tolist(),
             rerun[2].nonzero().flatten().tolist()]:
        raise SystemExit(f"path {name}: the rerun round {rounds[-1]} is not "
                         f"the (round 1, retry 1) draw")
    want = {**dict.fromkeys(launches, 0),
            "storm3_step": len(state.vars) * len(step_ms)}
    if launches != want or restore is None:
        raise SystemExit(f"path {name} launched {launches}, expected {want}"
                         f" (rollback {restore})")
    val = run.eval_fn(state)
    if not math.isfinite(val):
        raise SystemExit(f"non-finite validation loss {val} on path {name}")
    sizes = [f"{str(g.dtype).replace('torch.', '')}[{exp.problem.num_clients}"
             f", {g.padded}]" for g in run.init.spec.groups]
    held = sum(_state_bytes(snap[1]) for snap in guard._good)
    log(f"path {name}: full-width {run.model_cfg.name} ("
        f"{run.model_cfg.num_layers} layers), buffers {sizes}, "
        f"steps {len(step_ms)} (4, then round 1 again), step ms "
        f"{[round(x, 3) for x in step_ms]}, share of each step in the "
        f"guarded reductions (CUDA events; each step's time includes the "
        f"screen recomputed from scratch) {shares}, peak memory {peak} B, "
        f"launches {launches}, val_loss {val}, on {card_line()}")
    log(f"path {name}: rounds (injected NaN and byzantine clients, screened) "
        f"{rounds}; every verdict the screen recomputed from scratch, least "
        f"margin {min(margins):.3e} of tol; the state finite after every "
        f"round")
    log(f"path {name}: host snapshots at steps {[g[0] for g in guard._good]}"
        f" held, {held} B of host memory ({robust.ring} × {held // 2} B), "
        f"snapshot s {snap_s} (the first ones allocate, the last reuses the "
        f"evicted one's host tensors); a non-finite loss observed at step "
        f"{steps} in place of {restore[1]}: restored step {local} in "
        f"{restore[0]} s into the live tensors bit for bit, retry 1, round "
        f"1 rerun on its (1, 1) draws")
    return launches


# ---------------------------------------------------------------------------
# phases 4 and 5: telemetry, the event stream through the train CLI
# ---------------------------------------------------------------------------

def cli_schedule_phase() -> None:
    """The train CLI on the card with the schedule's flags: the reduced
    ``fedbioacc.json`` with ``--clients 4 --hierarchy-period 2
    --comm-every u=2``, 4 steps.  A run hard-exits after step 1, inside
    pod-local round 1 (``--crash-at-step 1``, a subprocess, exit 17);
    ``--resume`` (in process) must end as the uninterrupted run (in
    process, with a sink) does, bit for bit: every logged line and every
    array of the final checkpoint; the uninterrupted run's ``comm`` events
    must be ``round_bytes``' for rounds 1 and 2, round 1 without u."""
    spec = os.path.join(ROOT, "experiments", "fedbioacc.json")
    flags = ["--experiment", spec, "--clients", "4", "--steps", "4",
             "--hierarchy-period", "2", "--comm-every", "u=2",
             "--device", "cuda", "--log-every", "1", "--ckpt-every", "1"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_schedule_") as d:
        crashed, whole = os.path.join(d, "crashed"), os.path.join(d, "whole")
        sink = os.path.join(d, "events.jsonl")
        _cli(flags + ["--ckpt-dir", crashed, "--crash-at-step", "1"], 17)
        strip = lambda hs: [{k: v for k, v in h.items()  # noqa: E731
                             if k != "wall_s"} for h in hs]
        resumed = strip(train_cli.main(
            ["--resume", crashed, "--ckpt-dir", crashed, "--device", "cuda",
             "--log-every", "1", "--ckpt-every", "1"]))
        full = strip(train_cli.main(flags + ["--ckpt-dir", whole,
                                             "--telemetry-sink", sink]))
        mine, want = _final_arrays(crashed), _final_arrays(whole)
        same = (resumed == full[1:] and len(mine) == len(want)
                and checkpoint_metadata(crashed) == checkpoint_metadata(whole)
                and all(a.dtype == b.dtype and np.array_equal(
                    np.atleast_1d(a).view(np.uint8),
                    np.atleast_1d(b).view(np.uint8))
                    for a, b in zip(mine, want)))
        exp = train_cli.apply_overrides(Experiment.load(spec), {
            "clients": 4, "steps": 4, "hierarchy_period": 2,
            "comm_every": "u=2"})
        run = build(exp, device="cpu")
        plan = comm_plan(run.step.spec, run.step.aspec, None)
        comm = [e for e in read_events(sink) if e["event"] == "comm"]
        e = {sec: el for sec, el, _, _ in plan.sections}
        events_ok = (
            [c["round"] for c in comm] == [1, 2]
            and all({k: c[k] for k in rb} == rb for c, rb in
                    zip(comm, (round_bytes(plan, 1), round_bytes(plan, 2))))
            and comm[0]["elems"] == e["x"] + e["y"])
    log(f"train CLI, fedbioacc.json --clients 4 --hierarchy-period 2 "
        f"--comm-every u=2 on the card: crashed after step 1 (exit 17), "
        f"resumed: steps {[h['step'] for h in resumed]} and the final "
        f"checkpoint's {len(want)} arrays "
        f"{'bit for bit' if same else 'NOT'} the uninterrupted run's; comm "
        f"events (round, elems) {[(c['round'], c['elems']) for c in comm]}"
        f"{'' if events_ok else ' NOT'} as round_bytes, round 1 without u")
    if not (same and events_ok):
        raise SystemExit("train CLI with the schedule's flags failed")


def _cli_in_process(args: list, hook) -> list:
    """``repro_torch.launch.train.main(args)`` in this process, each run it
    builds passed through ``hook(run) -> run``."""
    orig = train_cli.build
    train_cli.build = lambda exp, device=None: hook(orig(exp, device=device))
    try:
        return train_cli.main(args)
    finally:
        train_cli.build = orig


def _events_seq(events: list) -> list:
    return [(e["event"], e.get("step"), e.get("round")) for e in events]


def _envelope_free(ev: dict) -> dict:
    return {k: v for k, v in ev.items() if k not in ("seq", "ts", "wall_s")}


def telemetry_cross_check(dev) -> None:
    """The reduced ``fedbioacc_telemetry.json`` through the train CLI in
    process for 4 steps (two rounds) with ``--telemetry-sink``, on the
    card and on the CPU, both from the CPU's initial state: the streams
    validate, their ``(event, step, round)`` sequences are equal, the
    ``comm`` events equal, and every ``metrics`` value within
    ``METRIC_TOL`` of the CPU's (relative)."""
    spec = os.path.join(ROOT, "experiments", f"{TELEMETRY}.json")
    exp = Experiment.load(spec)
    init0 = build(exp, device="cpu").init(
        torch.Generator().manual_seed(exp.schedule.seed))

    def same_start(run):
        return run._replace(init=lambda _gen: init0._replace(
            vars=tuple(b.to(run.device, copy=True) for b in init0.vars),
            mom=tuple(b.to(run.device, copy=True) for b in init0.mom)))

    streams = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tel_") as tmp:
        for side, device in (("cpu", "cpu"), ("card", dev.type)):
            sink = os.path.join(tmp, f"{side}.jsonl")
            _cli_in_process(["--experiment", spec, "--steps", "4",
                             "--log-every", str(TEL_LOG_EVERY), "--device",
                             device, "--telemetry-sink", sink], same_start)
            validate_events(sink, expect=("run_start", "metrics", "comm",
                                          "run_end"))
            streams[side] = read_events(sink)
    cpu, gpu = streams["cpu"], streams["card"]
    if _events_seq(cpu) != _events_seq(gpu):
        raise SystemExit(f"telemetry cross-check: the event sequences "
                         f"differ: {_events_seq(cpu)} vs {_events_seq(gpu)}")
    worst, n = 0.0, 0
    for c, g in zip(cpu, gpu):
        if c["event"] == "comm" and _envelope_free(c) != _envelope_free(g):
            raise SystemExit(f"telemetry cross-check: comm events differ: "
                             f"{c} vs {g}")
        if c["event"] != "metrics":
            continue
        c, g = _envelope_free(c), _envelope_free(g)
        if list(c) != list(g):
            raise SystemExit(f"telemetry cross-check: metrics keys differ: "
                             f"{list(c)} vs {list(g)}")
        for k in c:
            for x, y in zip(np.ravel(c[k]), np.ravel(g[k])):
                if k in ("step", "retry") or x == y:
                    continue
                worst = max(worst, abs(x - y) / max(abs(x), 1e-30))
                n += 1
    log(f"telemetry cross-check, {TELEMETRY} (reduced, 4 steps, train CLI "
        f"in process): card and CPU streams valid, (event, step, round) "
        f"sequences equal ({len(cpu)} events), comm events equal, {n} "
        f"metrics values differ, worst relative difference {worst:.3e} "
        f"(limit {METRIC_TOL}); {time.perf_counter() - t0:.1f} s")
    if not worst <= METRIC_TOL:
        raise SystemExit("telemetry cross-check: metrics off the CPU's")


def _timed_passes(passes: list, step_ms: list):
    """The engine's metric passes (``METRIC_PASSES`` of ``optim.flat``),
    each between two CUDA events recorded on the current stream, with the
    index of the step it belongs to (no synchronization inside a step)."""
    def timed(fn):
        def wrapped(*args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(*args, **kw)
            end.record()
            passes.append((len(step_ms), start, end))
            return out
        return wrapped
    return {name: timed(getattr(flat, name)) for name in METRIC_PASSES}


def telemetry_path(name: str, exp: Experiment, dev) -> dict:
    """The full-width telemetry path through the train CLI in process
    (``--device cuda``, a sink in a temporary directory, ``--log-every
    2``): each step between two synchronizations, the metric passes
    between CUDA events; the stream must validate (comm bytes reconciled),
    every in-band value must be finite, and the path must launch as
    ``PATHS`` says.  Logs the step times, the passes' share of each step,
    the peak memory and the ``launch.metrics`` summary.  Returns the
    launches."""
    step_ms, passes = [], []

    def timed_steps(run):
        step = run.step

        @functools.wraps(step)
        def stepped(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return run._replace(step=stepped)

    orig = {n: getattr(flat, n) for n in METRIC_PASSES}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tel_") as tmp:
        spec, sink = (os.path.join(tmp, f) for f in ("spec.json",
                                                     "events.jsonl"))
        exp.save(spec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        for n, fn in _timed_passes(passes, step_ms).items():
            setattr(flat, n, fn)
        try:
            history = _cli_in_process(
                ["--experiment", spec, "--device", dev.type, "--log-every",
                 str(TEL_LOG_EVERY), "--telemetry-sink", sink], timed_steps)
        finally:
            for n, fn in orig.items():
                setattr(flat, n, fn)
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        summary = validate_events(sink, expect=("run_start", "metrics",
                                                "comm", "span", "run_end"))
        events = read_events(sink)
        log(f"path {name}: launch.metrics summary of its stream:")
        tel_metrics.main([sink, "--table"])
    inband = [e for e in events if e["event"] == "metrics" and
              any(k.startswith("upd_norm/") for k in e)]
    values = [v for e in inband for k, v in e.items()
              if "/" in k for v in np.ravel(v)]
    if len(inband) != 3 or not all(math.isfinite(v) for v in values):
        raise SystemExit(f"path {name}: in-band metrics events {inband}")
    if summary["comm_reconciled"] != 2:
        raise SystemExit(f"path {name}: {summary}")
    if not all(math.isfinite(h["val_loss"]) for h in history):
        raise SystemExit(f"non-finite validation loss on path {name}: "
                         f"{history}")
    want = {**dict.fromkeys(launches, 0), **PATHS[name]}
    if launches != want or len(step_ms) != exp.schedule.steps:
        raise SystemExit(f"path {name} launched {launches}, expected {want}"
                         f" ({len(step_ms)} steps)")
    shares = [round(sum(s.elapsed_time(e) for i, s, e in passes if i == t)
                    / step_ms[t], 5) for t in range(len(step_ms))]
    pass_ms = [round(sum(s.elapsed_time(e) for i, s, e in passes if i == t),
                     3) for t in range(len(step_ms))]
    log(f"path {name}: full-width through the train CLI, "
        f"{exp.problem.num_clients} clients, steps {len(step_ms)}, step ms "
        f"{[round(t, 3) for t in step_ms]}, metric passes ms {pass_ms} "
        f"(share of each step {shares}; CUDA events), peak memory {peak} B, "
        f"launches {launches}, val_loss {[h['val_loss'] for h in history]}, "
        f"stream {summary['events']} events valid, "
        f"{summary['comm_reconciled']} comm events reconciled, "
        f"{summary['by_type']}, on {card_line()}")
    return launches


def _schedule_bytes(groups, m: int, cp) -> tuple:
    """(the flat state's bytes, what a communication step holds while it
    reduces its largest run) over ``m`` clients of a compressed path:
    per element the variable in its buffer's dtype, the f32 momentum and,
    with error feedback, two f32 EF buffers; during the reduction also the
    step's new variables and momenta and, over the run, the f32 row + EF,
    the f32 send and its int8 pack (with top-k also the f32 magnitudes and
    the kept selection; with EF the EF copy the reduction writes)."""
    ef = cp.topk_frac > 0 and cp.error_feedback
    state = m * sum(g.padded * (g.dtype.itemsize + 4 + 8 * ef)
                    for g in groups)
    new = m * sum(g.padded * (g.dtype.itemsize + 4) for g in groups)
    temp = 9 + 9 * (cp.topk_frac > 0) + 4 * ef
    return state, state + new + m * max(g.padded for g in groups) * temp


def _timed_reductions(fn, spec, calls: list):
    """``flat.client_mean_masked`` that also appends ``(start event, end
    event, elements reduced)`` to ``calls``: two CUDA events on the current
    stream, with no synchronization, and the elements of the runs its
    modes communicate."""
    def timed(fspec, bufs, modes, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        elems = sum(b - a for grp in spec.groups for sec, a, b in grp.extents
                    if modes[sec] != "none")
        start.record()
        out = fn(fspec, bufs, modes, **kw)
        end.record()
        calls.append((start, end, elems))
        return out
    return timed


def _schedule_report(name: str, run, exp: Experiment, calls: list,
                     step_ms: list) -> None:
    """Log the reductions' time and share of each step of a path of the
    communication schedule, and check each round's elements reduced
    against ``round_bytes`` of the run's comm plan (the ``comm`` event the
    train CLI writes for the round): ``reductions × elems`` (variables and
    momenta), u left out of a round its cadence skips."""
    plan = comm_plan(run.step.spec, run.step.aspec, exp.compression)
    local = exp.schedule.local_steps
    per_step = [[c for c in calls if c[3] == t] for t in range(len(step_ms))]
    ms = [sum(s.elapsed_time(e) for s, e, _, _ in st) for st in per_step]
    events = []
    for t, st in enumerate(per_step):
        if (t + 1) % local:
            if st:
                raise SystemExit(f"path {name}: step {t + 1} reduced")
            continue
        rb = round_bytes(plan, (t + 1) // local)
        moved = sum(el for _, _, el, _ in st)
        if rb is None or moved != rb["reductions"] * rb["elems"]:
            raise SystemExit(f"path {name}: step {t + 1} reduced {moved} "
                             f"elements; its comm event says {rb}")
        events.append(rb)
    if name == HIERARCHICAL:
        e = {sec: el for sec, el, _, _ in plan.sections}
        if events[0]["elems"] != e["x"] + e["y"] or \
                events[1]["elems"] != e["x"] + e["y"] + e["u"]:
            raise SystemExit(f"path {name}: round 1 should reduce x and y, "
                             f"round 2 x, y and u: {events}")
    log(f"path {name}: reductions per step {[round(v, 3) for v in ms]} ms "
        f"(CUDA events around each masked reduction), share of the step "
        f"{[round(v / w, 4) for v, w in zip(ms, step_ms)]}; comm events "
        f"(round, elems, bytes_wire) "
        f"{[(e['round'], e['elems'], e['bytes_wire']) for e in events]} "
        f"equal to the elements the reductions moved, on {card_line()}")


def main_path(name: str, exp: Experiment, dev) -> dict:
    oracle_events = []
    over_clients = trainer._over_clients
    if exp.stragglers is not None:
        trainer._over_clients = _timed_oracles(over_clients, oracle_events)
    try:
        run = build(exp, device=dev)
    finally:
        trainer._over_clients = over_clients
    scheduled = name in (HIERARCHICAL, STRAGGLED_INT8)
    reductions, masked = [], flat.client_mean_masked
    if scheduled:
        state_b, least_b = _schedule_bytes(run.init.spec.groups,
                                           exp.problem.num_clients,
                                           exp.compression)
        log(f"path {name}: reckoned before the run from the layout: flat "
            f"state {state_b} B, {least_b} B held while a step reduces its "
            f"largest run (the oracles' own bytes not counted)")
        flat.client_mean_masked = _timed_reductions(masked, run.init.spec,
                                                    reductions)
    try:
        return _main_path(name, exp, run, oracle_events, reductions, dev)
    finally:
        flat.client_mean_masked = masked


def _main_path(name: str, exp: Experiment, run, oracle_events: list,
               reductions: list, dev) -> dict:
    state = run.init(torch.Generator(device=dev).manual_seed(exp.schedule.seed))
    data = torch.Generator().manual_seed(exp.schedule.seed)
    batches = [run.batch_fn(data) for _ in range(exp.schedule.steps)]
    part, local = run.init.participation, exp.schedule.local_steps
    strag = run.step.stragglers
    clients = exp.problem.num_clients
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    step_ms, packs, masks, rounds, shares = [], [], [], [], []
    decided, ckpt = [], None
    gated = part is not None or strag is not None
    for t, batch in enumerate(batches):
        if gated:
            mask = (torch.ones(clients) if part is None
                    else part.mask_fn(t // local))
            if t % local == 0:
                masks.append(mask.tolist())
            # which stragglers a step freezes is known only once the step
            # has decided its round, so a straggler path keeps every row
            keep = (range(clients) if strag is not None
                    else [i for i in range(clients) if mask[i] == 0])
            # on the host, so that the peak below is the step's own
            kept = [{i: b[i].cpu() for i in keep} for b in _state_rows(state)]
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        before, n_oracle = qp.LAUNCHES["quantpack"], len(oracle_events)
        n_red = len(reductions)
        state, metrics = run.step(state, batch)
        torch.cuda.synchronize()
        reductions[n_red:] = [(*c, t) for c in reductions[n_red:]]
        step_ms.append((time.perf_counter() - t0) * 1e3)
        packs.append(qp.LAUNCHES["quantpack"] - before)
        launch = entered = mask if gated else None
        if strag is not None:
            dec = metrics["decision"]
            if "stragglers" in run.step.telemetry_groups:
                _inband_is_decision(name, t, metrics, dec)
            entered = dec["arrivals"]
            if strag.spec.late_policy != "carry":
                launch = entered
            if bool(torch.any(entered > mask)):
                raise SystemExit(f"path {name}: step {t} arrived "
                                 f"{entered.tolist()}, not all sampled "
                                 f"({mask.tolist()})")
            ins = [i for i in range(clients) if entered[i] > 0]
            late = [i for i in range(clients) if mask[i] > 0 and i not in ins]
            calls = [(i, s.elapsed_time(e))
                     for i, s, e in oracle_events[n_oracle:]]
            shares.append(tuple(
                round(sum(ms for i, ms in calls if i in who) / step_ms[-1], 4)
                for who in (late, [i for i in range(clients)
                                   if mask[i] == 0])))
            if t % local == 0:
                rounds.append({
                    "round": t // local,
                    "sampled": [i for i in range(clients) if mask[i] > 0],
                    "arrived": ins, "quorum": dec["quorum"],
                    "extensions": dec["extensions"],
                    "deadline": dec["deadline"],
                    "deadline_next": dec["deadline_next"]})
        if gated:
            out = [i for i in range(clients) if launch[i] == 0]
            ins = [i for i in range(clients) if entered[i] > 0]
            _participation_checks(name, run, state, kept, out, ins,
                                  (t + 1) % local == 0)
            del kept
        if name == STRAGGLED:
            decided.append(_decision(metrics))
            if t + 1 == RESUME_AT:
                # outside the timed steps
                ckpt = save_full_width(run, state)
    launches, variants = launch_counts(), variant_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    val = run.eval_fn(state)
    sizes = [f"{str(g.dtype).replace('torch.', '')}[{clients}, {g.padded}]"
             for g in run.init.spec.groups]
    log(f"path {name}: full-width {run.model_cfg.name} ("
        f"{run.model_cfg.num_layers} layers), buffers {sizes}, "
        f"steps {len(step_ms)}, step ms {[round(t, 3) for t in step_ms]}, "
        f"peak memory {peak} B, launches {launches}, "
        f"val_loss {val}")
    if strag is not None:
        _straggler_report(name, strag, part, rounds, shares)
        log(f"path {name}: {clients} clients, sampled by round {masks}, "
            f"staleness counters {state.stale.tolist()}; every step left "
            f"the rows its launch mask ({strag.spec.late_policy}) left out "
            f"at their entering bits"
            f"{' (error feedback too)' if state.ef else ''}, every round "
            f"the arrivals' rows bit-identical")
    elif name == HIERARCHICAL:
        log(f"path {name}: {clients} clients in "
            f"{run.fed.hierarchy_groups} pods, masks by round {masks}, "
            f"staleness counters {state.stale.tolist()}; every step left "
            f"the non-participants' rows (variables and momenta) at their "
            f"entering bits; after pod-local round 1 each pod's "
            f"participants' x, y, nu and omega rows bit-identical and the "
            f"pods' not, the u and q rows of no two participants equal; "
            f"after global round 2 every participant's rows bit-identical")
    elif part is not None:
        log(f"path {name}: {clients} clients, masks by round {masks}, "
            f"staleness counters {state.stale.tolist()}; every step left "
            f"the non-participants' rows at their entering bits, every "
            f"round the participants' x and nu rows bit-identical and "
            f"their y and omega rows not")
    if reductions:
        _schedule_report(name, run, exp, reductions, step_ms)
    if launches["quantpack"]:
        log(f"path {name}: quantpack launches per step {packs} "
            f"({exp.schedule.local_steps} local steps a communication "
            f"round), by kernel {qp.VARIANTS}")
        if variants["quantpack_cluster"] != launches["quantpack"]:
            raise SystemExit(f"path {name}: not every pack ran the cluster "
                             f"kernel ({qp.VARIANTS})")
    want = {**dict.fromkeys(launches, 0), **PATHS[name]}
    if len(run.init.spec.groups) != 2 or exp.schedule.steps != 4:
        raise SystemExit(f"path {name}: PATHS counts launches for 4 steps "
                         f"over 2 buffers")
    if launches != want:
        raise SystemExit(f"path {name} launched {launches}, expected {want}")
    if not math.isfinite(val):
        raise SystemExit(f"non-finite validation loss {val} on path {name}")
    if ckpt is not None:
        # the uninterrupted run's end on the host, so that the card holds
        # one state at a time
        final = {"bufs": [b.cpu() for b in state.vars + state.mom],
                 "step": state.step, "stale": state.stale.clone(),
                 "deadline": state.deadline.clone()}
        del state
        torch.cuda.empty_cache()
        resumed = resume_full_width(name, run, final, ckpt, batches,
                                    decided, dev)
        launches = {k: v + resumed[k] for k, v in launches.items()}
    return launches


# ---------------------------------------------------------------------------
# phase 4b: the sharded substrate on a [4, 2] mesh of gloo ranks
# ---------------------------------------------------------------------------

SHARDED = "fedbioacc_sharded_overlap"
SHARDED_MESH = (4, 2)
SHARDED_TOL = 1e-5           # card against CPU, of each field's norm
SHARDED_TIMEOUT = 900.0      # seconds the ranks may take, beside phase 4
# (d)/(e): stragglers, faults with the guarded means and rollback, and
# in-band telemetry on the mesh
GUARDED = (STRAGGLED, FAULTY, TELEMETRY)
GUARD_METRIC_TOL = 1e-4      # in-band metrics, card against CPU, relative
# (e) at full width, each run one round (2 steps), by run: (committed spec,
# its edits, the steps it runs, the step whose metric passes and guarded
# means also run on CPU copies of their inputs, 0 for none).  The faulty
# spec with its faults from round 0 on, fault seed 45: NaN from clients 2
# and 5 and ×25 from 0 and 7 (the committed spec's kinds and rates; its
# round 1, seed 7, sends NaN from 2 and 5 and ×25 from 4 and 7), the
# screen, the z-score and clip as committed, with the health metrics.  The
# faulty spec cut to 4 clients, the plain mean and no screen, fault seed
# 13: round 0 sends NaN (clients 2 and 3) at retry 0 and none at retry 1,
# so the run rolls back once, to step 1, and runs on (3 steps).  The
# telemetry spec with int8 sends and the compression metrics
ROLLBACK_EDITS = {"problem.num_clients": 4, "faults.nan_rate": 0.2,
                  "faults.byzantine_rate": 0.0, "faults.seed": 13,
                  "faults.start_round": 0, "robustness.aggregator": "mean",
                  "robustness.screen": False}
FULL_RUNS = {
    "straggler": (STRAGGLED, {}, 2, 0),
    "faulty": (FAULTY, {"faults.start_round": 0, "faults.seed": 45,
                        "telemetry.metrics": ["norms", "drift", "health"]},
               2, 2),
    "rollback": (FAULTY, ROLLBACK_EDITS, 3, 0),
    "telemetry": (TELEMETRY, {"compression.quant": "int8",
                              "telemetry.metrics": [
                                  "norms", "drift", "compression"]}, 2, 2),
}


def _sharded_specs(tmp: str) -> dict:
    """The phase's spec files: (a) the committed spec; (b) its edit at full
    width (4 steps with overlap) and (b') the same without overlap for one
    communication round; (c) the compressed spec edited to the mesh at
    that width, 4 clients, one communication round; (d) the straggler,
    faulty and telemetry specs edited to the mesh, 4 steps; (e) at full
    width the runs of ``FULL_RUNS``."""
    base = Experiment.load(os.path.join(ROOT, "experiments",
                                        f"{SHARDED}.json"))
    width = {"problem.reduced": False, "problem.seq_len": 512,
             "problem.per_client": 1}
    full = base.edit(**width)
    specs = {"a": base, "b": full,
             "seq": full.edit(**{"execution.overlap": False,
                                 "schedule.steps": 2}),
             "c": Experiment.load(os.path.join(
                 ROOT, "experiments", f"{COMPRESSED}.json")).edit(
                 **width, **{"problem.num_clients": 4,
                             "execution.mesh": list(SHARDED_MESH),
                             "schedule.steps": 2})}
    guard = {name: Experiment.load(os.path.join(
        ROOT, "experiments", f"{name}.json")).edit(**{
            "execution.mesh": list(SHARDED_MESH), "schedule.steps": 4})
        for name in GUARDED}
    for name in GUARDED:
        specs[f"d_{name}"] = guard[name]
    for run, (name, edits, _, _) in FULL_RUNS.items():
        specs[f"e_{run}"] = guard[name].edit(**width, **{
            "schedule.steps": 2, **edits})
    paths = {}
    for k, exp in specs.items():
        paths[k] = os.path.join(tmp, f"{k}.json")
        exp.save(paths[k])
    return paths


@contextlib.contextmanager
def _recorded_comm_step(entries: list):
    """``train_cli.build`` whose runs record the collectives of their first
    communication step on this rank (the reference's entries, as
    ``[entry, count]`` rows into ``entries``)."""
    from repro_torch.analysis.collectives import record_collectives
    orig = train_cli.build

    def recording_build(exp, **kw):
        run = orig(exp, **kw)
        inner = run.step

        def step(state, batch):
            if entries or state.step != run.spec.schedule.local_steps - 1:
                return inner(state, batch)
            with record_collectives(run.shard.mesh) as rec:
                out = inner(state, batch)
            entries.extend(_entries_json(rec.counter()))
            return out

        step.__dict__.update(inner.__dict__)
        return run._replace(step=step)

    train_cli.build = recording_build
    try:
        yield
    finally:
        train_cli.build = orig


@contextlib.contextmanager
def _timed_steps(times: list):
    """``train_cli.build`` whose runs time each step on the host, between
    two synchronizations of the card (milliseconds into ``times``)."""
    orig = train_cli.build

    def timed_build(exp, **kw):
        run = orig(exp, **kw)
        inner = run.step

        def step(state, batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = inner(state, batch)
            torch.cuda.synchronize()
            times.append(round((time.perf_counter() - t) * 1e3, 3))
            return out

        step.__dict__.update(inner.__dict__)
        return run._replace(step=step)

    train_cli.build = timed_build
    try:
        yield
    finally:
        train_cli.build = orig


@contextlib.contextmanager
def _timed_comm(records: list):
    """``seqs.comm_buffers`` timed at communication steps: each call's time
    to return (the whole reduction when synchronous, its issue when the
    overlap leaves it pending) and the time the step then waits for its
    pending writes, between synchronizations of the card."""
    orig = seqs.comm_buffers

    def timed(spec, cfg, step, bufs, policies, **kw):
        if (step + 1) % cfg.local_steps:
            return orig(spec, cfg, step, bufs, policies, **kw)
        pending = kw.get("pending")
        n0 = 0 if pending is None else len(pending)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(spec, cfg, step, bufs, policies, **kw)
        torch.cuda.synchronize()
        rec = {"step": step, "pending": pending is not None,
               "elems": sum(b.numel() for b in bufs),
               "issue_ms": round((time.perf_counter() - t) * 1e3, 3),
               "wait_ms": 0.0}
        records.append(rec)

        def waited(fn):
            def finish():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                rec["wait_ms"] = round(rec["wait_ms"] + (
                    time.perf_counter() - t0) * 1e3, 3)
            return finish

        for i in range(n0, len(pending or ())):
            pending[i] = waited(pending[i])
        return out

    seqs.comm_buffers = timed
    try:
        yield
    finally:
        seqs.comm_buffers = orig


@contextlib.contextmanager
def _keep_checkpoint(step: int, src: str, dst: str):
    """``train_cli.save_checkpoint`` that also copies ``src`` to ``dst``
    once the checkpoint of ``step`` is written (rank 0 writes)."""
    orig = train_cli.save_checkpoint

    def save(path, tree, meta, **kw):
        orig(path, tree, meta, **kw)
        if path == src and meta.get("step") == step:
            shutil.copytree(src, dst)

    train_cli.save_checkpoint = save
    try:
        yield
    finally:
        train_cli.save_checkpoint = orig


@contextlib.contextmanager
def _timed_rollback(records: dict):
    """``RollbackGuard``'s host snapshot and restore, timed between
    synchronizations of the card (seconds into ``records["snapshot"]`` and
    ``records["restore"]``)."""
    from repro_torch.federation import faults
    orig = {"snapshot": faults._host_copy, "restore": faults._restore}

    def timed(key):
        def fn(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig[key](*args)
            torch.cuda.synchronize()
            records.setdefault(key, []).append(
                round(time.perf_counter() - t, 4))
            return out
        return fn

    faults._host_copy, faults._restore = timed("snapshot"), timed("restore")
    try:
        yield
    finally:
        faults._host_copy, faults._restore = (orig["snapshot"],
                                              orig["restore"])


_METRIC_PASSES = ("section_norms", "section_drift", "quant_roundtrip_err",
                  "health_screen")


@contextlib.contextmanager
def _on_cpu_at(at: int, e: dict):
    """Runs of ``train_cli.build`` whose step ``at`` (1-based; 0 for none)
    also runs the in-band metric passes of ``optim/flat.py`` and the
    guarded mean of a run on a rank's block (``flat._robust_mean_sharded``)
    on CPU copies of what the step hands them on the card, every rank in
    the same order, so that the CPU side's gloo collectives match too.
    Into ``e``: ``metrics``, each pass call's results on both devices as
    ``[pass, {key: (card, CPU)}]``; ``guarded``, each guarded mean's
    elements, its time on the card (between synchronizations, its gloo
    collectives included), its result's relative error against the CPU's
    and both devices' screen verdicts; ``pass_packs``, the ``quantpack``
    launches of each card call of the quantization pass (the rest are the
    int8 wire's)."""
    orig = {n: getattr(flat, n) for n in (*_METRIC_PASSES,
                                          "_robust_mean_sharded")}
    orig_build = train_cli.build
    armed = [False]
    e.update(metrics=[], guarded=[], pass_packs=[])

    def cpu(v):
        # plain tuples and lists of tensors (buffers, the fault masks); the
        # spec and the ShardCtx pass as they are
        if torch.is_tensor(v):
            return v.cpu()
        if type(v) in (tuple, list):
            return type(v)(cpu(x) for x in v)
        return v

    def flat_out(out):
        return (dict(out) if isinstance(out, dict) else {"": out})

    def armed_build(exp, **kw):
        run = orig_build(exp, **kw)
        inner = run.step

        def step(state, batch):
            armed[0] = int(state.step) + 1 == at
            try:
                return inner(state, batch)
            finally:
                armed[0] = False

        step.__dict__.update(inner.__dict__)
        return run._replace(step=step)

    def wrapped(name):
        def fn(*args, **kw):
            n0 = qp.LAUNCHES["quantpack"]
            out = orig[name](*args, **kw)
            if name == "quant_roundtrip_err":
                e["pass_packs"].append(qp.LAUNCHES["quantpack"] - n0)
            if armed[0]:
                ref = orig[name](*cpu(args),
                                 **{k: cpu(v) for k, v in kw.items()})
                got, want = flat_out(out), flat_out(ref)
                e["metrics"].append([name, {
                    k: (got[k].cpu().reshape(-1).tolist(),
                        want[k].reshape(-1).tolist()) for k in sorted(got)}])
            return out
        return fn

    def guarded(seg, w, corrupt, robust, shard, m, verdicts):
        if not armed[0]:
            return orig["_robust_mean_sharded"](seg, w, corrupt, robust,
                                                shard, m, verdicts)
        host = seg.to("cpu", copy=True)
        mine = None if verdicts is None else []
        torch.cuda.synchronize()
        t = time.perf_counter()
        orig["_robust_mean_sharded"](seg, w, corrupt, robust, shard, m,
                                     verdicts)
        torch.cuda.synchronize()
        ms = round((time.perf_counter() - t) * 1e3, 3)
        orig["_robust_mean_sharded"](host, cpu(w), cpu(corrupt), robust,
                                     shard, m, mine)
        want = host.to(seg.device)
        err = float(torch.linalg.vector_norm(
            seg.to(torch.float64) - want.to(torch.float64))
            / torch.clamp_min(torch.linalg.vector_norm(
                want, dtype=torch.float64), 1e-30))
        e["guarded"].append({
            "elems": seg.numel(), "ms": ms, "rel": err,
            "verdicts": ([] if mine is None else
                         [verdicts[-1].tolist(), mine[-1].tolist()])})

    train_cli.build = armed_build
    for n in _METRIC_PASSES:
        setattr(flat, n, wrapped(n))
    flat._robust_mean_sharded = guarded
    try:
        yield
    finally:
        train_cli.build = orig_build
        for n, fn in orig.items():
            setattr(flat, n, fn)


def _sharded_rank(rank: int, world: int, store: str, tmp: str) -> None:
    """One rank of phase 4b: every run of the phase through the train CLI's
    ``main`` in this process (one gloo world for all of them); writes its
    counts, times and peak memory to ``tmp/rank<r>.json``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks
    init_ranks(rank, world, store)
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if rank:
        sys.stdout = open(os.devnull, "w")
    with open(os.path.join(tmp, "specs.json")) as fh:
        specs = json.load(fh)
    out = {"rank": rank}
    t = time.perf_counter()
    # (a) the CPU runs the spec, the card resumes the CPU's step-2
    # checkpoint (the initial states are drawn on each device otherwise)
    a_cpu, a_step2 = (os.path.join(tmp, d) for d in ("a-cpu", "a-step2"))
    with _keep_checkpoint(2, a_cpu, a_step2):
        out["a_cpu"] = train_cli.main([
            "--experiment", specs["a"], "--device", "cpu", "--log-every",
            "1", "--ckpt-dir", a_cpu, "--ckpt-every", "2"])
    dist.barrier()
    out["a_cuda"] = train_cli.main([
        "--resume", a_step2, "--device", "cuda", "--log-every", "1",
        "--ckpt-dir", os.path.join(tmp, "a-cuda"), "--ckpt-every", "2"])
    out["a_s"] = round(time.perf_counter() - t, 1)
    # (d) stragglers, faults and in-band telemetry at the specs' own size:
    # the CPU runs 4 steps, the card steps 3-4 from its step-2 checkpoint
    t = time.perf_counter()
    for name in GUARDED:
        d_cpu, d_step2 = (os.path.join(tmp, f"d-{name}-{x}")
                          for x in ("cpu", "step2"))
        with _keep_checkpoint(2, d_cpu, d_step2):
            out[f"d_{name}_cpu"] = train_cli.main([
                "--experiment", specs[f"d_{name}"], "--device", "cpu",
                "--log-every", "1", "--ckpt-dir", d_cpu, "--ckpt-every",
                "2"])
        dist.barrier()
        out[f"d_{name}_cuda"] = train_cli.main([
            "--resume", d_step2, "--device", "cuda", "--log-every", "1",
            "--ckpt-dir", os.path.join(tmp, f"d-{name}-cuda"),
            "--ckpt-every", "2"])
    out["d_s"] = round(time.perf_counter() - t, 1)
    with _depth(MAIN_LAYERS):
        t = time.perf_counter()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        b_dir, b2_dir = (os.path.join(tmp, d) for d in ("b", "b-step2"))
        out["b_steps_ms"], out["b_comm"], out["b_entries"] = [], [], []
        with _timed_steps(out["b_steps_ms"]), _timed_comm(out["b_comm"]), \
                _recorded_comm_step(out["b_entries"]), \
                _keep_checkpoint(2, b_dir, b2_dir):
            out["b"] = train_cli.main([
                "--experiment", specs["b"], "--device", "cuda",
                "--log-every", "2", "--ckpt-dir", b_dir, "--ckpt-every",
                "2"])
        torch.cuda.synchronize()
        out["b_launches"] = launch_counts()
        out["b_peak"] = torch.cuda.max_memory_allocated()
        out["b_s"] = round(time.perf_counter() - t, 1)
        dist.barrier()
        t = time.perf_counter()
        reset_counts()
        out["b_resumed_steps_ms"] = []
        with _timed_steps(out["b_resumed_steps_ms"]):
            out["b_resumed"] = train_cli.main([
                "--resume", b2_dir, "--device", "cuda", "--log-every", "2",
                "--ckpt-dir", os.path.join(tmp, "b-resumed"),
                "--ckpt-every", "2"])
        out["b_resumed_launches"] = launch_counts()
        out["resume_s"] = round(time.perf_counter() - t, 1)
        t = time.perf_counter()
        out["seq_comm"], out["seq_steps_ms"] = [], []
        with _timed_steps(out["seq_steps_ms"]), _timed_comm(out["seq_comm"]):
            train_cli.main(["--experiment", specs["seq"], "--device", "cuda",
                            "--log-every", "2"])
        out["seq_s"] = round(time.perf_counter() - t, 1)
        t = time.perf_counter()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        out["c_steps_ms"] = []
        with _timed_steps(out["c_steps_ms"]):
            out["c"] = train_cli.main(["--experiment", specs["c"],
                                       "--device", "cuda", "--log-every",
                                       "2"])
        torch.cuda.synchronize()
        out["c_launches"] = launch_counts()
        out["c_variants"] = variant_counts()
        out["c_peak"] = torch.cuda.max_memory_allocated()
        out["c_s"] = round(time.perf_counter() - t, 1)
        # (e) the runs of FULL_RUNS at full width, on the card
        for key, (name, _, _, at) in FULL_RUNS.items():
            t = time.perf_counter()
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            e = {"steps_ms": [], "comm": [], "rollback": {}}
            printed = io.StringIO()
            with contextlib.ExitStack() as stack:
                stack.enter_context(_timed_steps(e["steps_ms"]))
                stack.enter_context(_timed_comm(e["comm"]))
                stack.enter_context(contextlib.redirect_stdout(printed))
                stack.enter_context(_timed_rollback(e["rollback"]))
                stack.enter_context(_on_cpu_at(at, e))
                sink = ([] if name != TELEMETRY else [
                    "--telemetry-sink", os.path.join(tmp, "e-events.jsonl")])
                e["lines"] = train_cli.main([
                    "--experiment", specs[f"e_{key}"], "--device", "cuda",
                    "--log-every", "1", *sink])
            torch.cuda.synchronize()
            e["printed"] = printed.getvalue()
            e["launches"] = launch_counts()
            e["peak"] = torch.cuda.max_memory_allocated()
            e["s"] = round(time.perf_counter() - t, 1)
            out[f"e_{key}"] = e
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    dist.barrier()
    dist.destroy_process_group()


def start_sharded_phase() -> tuple:
    """Write the phase's specs and start its ranks, which run beside phase
    4; returns what :func:`sharded_phase` joins."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    with open(os.path.join(tmp, "specs.json"), "w") as fh:
        json.dump(_sharded_specs(tmp), fh)
    world = SHARDED_MESH[0] * SHARDED_MESH[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_sharded_rank,
                         args=(r, world, os.path.join(tmp, "store"), tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, tmp, time.perf_counter()


def _ckpt_arrays(d: str, step: int = 4) -> list:
    with np.load(os.path.join(d, f"arrays-{step:08d}.npz")) as data:
        return [data[f"a{i}"].copy() for i in range(len(data.files))]


def _first_call(records: list) -> list:
    """The variable reduction of each communication step: the step's first
    ``comm_buffers`` call (the momenta's follows it)."""
    seen, out = set(), []
    for r in records:
        if r["step"] not in seen:
            seen.add(r["step"])
            out.append(r)
    return out


def _stop_ranks(procs: list) -> list:
    for p in procs:
        if p.exitcode is None:
            p.kill()
        p.join()
    return [p.exitcode for p in procs]


def sharded_phase(started: tuple) -> dict:
    """Join phase 4b's ranks and check what they wrote (see the module
    docstring); returns the launches of (b)'s and (c)'s runs, summed over
    the ranks, and the collectives rank 0 recorded at (b)'s round-1
    communication step."""
    procs, tmp, t0 = started
    for p in procs:
        p.join(max(1.0, t0 + SHARDED_TIMEOUT - time.perf_counter()))
    codes = _stop_ranks(procs)
    if codes != [0] * len(procs):
        raise SystemExit(f"phase 4b: the ranks exited {codes} (a rank "
                         f"still running after {SHARDED_TIMEOUT} s is "
                         f"killed)")
    ranks = []
    for r in range(len(procs)):
        with open(os.path.join(tmp, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    r0 = ranks[0]
    # (a) the committed spec: card against CPU, field by field
    for dev, n in (("cpu", 4), ("cuda", 2)):
        losses = [h["val_loss"] for h in r0[f"a_{dev}"]]
        if len(losses) != n or not all(math.isfinite(v) for v in losses):
            raise SystemExit(f"phase 4b (a): {dev} val_loss {losses}")
    errs = []
    for card, cpu in zip(_ckpt_arrays(os.path.join(tmp, "a-cuda")),
                         _ckpt_arrays(os.path.join(tmp, "a-cpu"))):
        c, h = (torch.from_numpy(np.asarray(v, np.float64))
                for v in (card, cpu))
        errs.append(float((c - h).norm()) / max(float(h.norm()), 1e-30))
    if not all(e <= SHARDED_TOL for e in errs):
        raise SystemExit(f"phase 4b (a): card against CPU, relative error "
                         f"by field {errs} > {SHARDED_TOL}")
    log(f"phase 4b (a): {SHARDED}.json on a [4, 2] mesh of 8 gloo ranks "
        f"(each on cuda:0), 4 steps on the CPU, steps 3-4 again on the card "
        f"from the CPU's step-2 checkpoint (its communication step with "
        f"overlap): relative error by field of the final state "
        f"{[f'{e:.3e}' for e in errs]} (within {SHARDED_TOL}); val_loss "
        f"CPU {[h['val_loss'] for h in r0['a_cpu']]}, card "
        f"{[h['val_loss'] for h in r0['a_cuda']]}; {r0['a_s']} s")
    # (b) full width with overlap: launches, times, memory, the resume
    b_dir = os.path.join(tmp, "b")
    final = _ckpt_arrays(b_dir)
    groups = (len(final) - 1) // 2        # variables, momenta, the step
    want = {k: 0 for k in r0["b_launches"]}
    want["storm3_step"] = len(ranks) * 4 * groups
    got = {k: sum(r["b_launches"][k] for r in ranks) for k in want}
    losses = [h["val_loss"] for h in r0["b"]]
    if got != want or not losses or not all(math.isfinite(v)
                                            for v in losses):
        raise SystemExit(f"phase 4b (b): launches over the ranks {got} "
                         f"(expected {want}), val_loss {losses}")
    resumed = [h["val_loss"] for h in r0["b_resumed"]]
    same = all(a.tobytes() == b.tobytes() for a, b in zip(
        final, _ckpt_arrays(os.path.join(tmp, "b-resumed"))))
    r_launches = sum(r["b_resumed_launches"]["storm3_step"] for r in ranks)
    if not same or resumed[-1] != losses[-1] or \
            r_launches != len(ranks) * 2 * groups:
        raise SystemExit(f"phase 4b (b): the run resumed at step 2 ended "
                         f"{'bit for bit' if same else 'otherwise'} "
                         f"(val_loss {resumed} against {losses}, "
                         f"storm3_step {r_launches})")
    over = [_first_call(r["b_comm"])[0] for r in ranks]
    seq = [_first_call(r["seq_comm"])[0] for r in ranks]
    hidden = [round(1.0 - (o["issue_ms"] + o["wait_ms"]) / s["issue_ms"], 4)
              for o, s in zip(over, seq)]
    log(f"phase 4b (b): full-width mamba2-130m ({MAIN_LAYERS} layers, bf16) "
        f"on the [4, 2] mesh, 4 clients, 4 steps with overlap, {groups} "
        f"dtype buffers; launches over the 8 ranks {got}; step ms by rank "
        f"{[r['b_steps_ms'] for r in ranks]}; peak memory by rank "
        f"{[r['b_peak'] for r in ranks]} B (sum "
        f"{sum(r['b_peak'] for r in ranks)} B); val_loss {losses}; "
        f"{r0['b_s']} s with the checkpoints of steps 2 and 4")
    log(f"phase 4b (b): the variable reduction of the communication step "
        f"({over[0]['elems']} elements a rank), by rank: with overlap "
        f"(issue ms, wait after the new-iterate oracle ms) "
        f"{[(o['issue_ms'], o['wait_ms']) for o in over]}; sequential (the "
        f"edit without overlap, 2 steps) ms {[s['issue_ms'] for s in seq]}; "
        f"share of the sequential time the overlap hides, by rank {hidden}; "
        f"the momentum reduction (sequential in both) ms "
        f"{[r['b_comm'][1]['issue_ms'] for r in ranks]}; sequential step "
        f"ms {[r['seq_steps_ms'] for r in ranks]}; {r0['seq_s']} s")
    log(f"phase 4b (b): resumed from the step-2 checkpoint by a second "
        f"main in the same ranks: steps 3-4 ms by rank "
        f"{[r['b_resumed_steps_ms'] for r in ranks]}, the final checkpoint "
        f"bit for bit the uninterrupted run's, storm3_step {r_launches} "
        f"launches; {r0['resume_s']} s, on {card_line()}")
    # (c) the compressed spec on the mesh
    c_got = {k: sum(r["c_launches"][k] for r in ranks)
             for k in r0["c_launches"]}
    c_var = {k: sum(r["c_variants"][k] for r in ranks)
             for k in r0["c_variants"]}
    packs = len(ranks) * 2 * groups       # variables and momenta, 1 round
    c_want = {k: 0 for k in c_got}
    c_want.update(storm3_step=len(ranks) * 2 * groups, quantpack=packs,
                  quantunpack=packs)
    c_loss = [h["val_loss"] for h in r0["c"]]
    pack_kernels = sum(v for k, v in c_var.items()
                       if k.startswith("quantpack_"))
    if c_got != c_want or pack_kernels != packs or \
            not all(math.isfinite(v) for v in c_loss):
        raise SystemExit(f"phase 4b (c): launches {c_got} (expected "
                         f"{c_want}), packs by kernel {c_var}, val_loss "
                         f"{c_loss}")
    log(f"phase 4b (c): {COMPRESSED}.json on the [4, 2] mesh at full width "
        f"(4 clients, 2 steps, int8 + top-k 10 % sends, the int8 wire): "
        f"launches over the ranks {c_got}, packs by kernel {c_var}; step ms "
        f"by rank {[r['c_steps_ms'] for r in ranks]}; peak memory by rank "
        f"{[r['c_peak'] for r in ranks]} B; val_loss {c_loss}; "
        f"{r0['c_s']} s")
    guard_check_specs(tmp, r0)
    e_got = guard_check_full(ranks, groups)
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 4b took {time.perf_counter() - t0:.1f} s from its start "
        f"(beside phase 4)")
    return ({k: got[k] + c_got[k] + e_got[k] for k in got},
            r0["b_entries"])


def _rel(a, b) -> float:
    a, b = (torch.as_tensor(np.asarray(v, np.float64)) for v in (a, b))
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _inband(path: str) -> dict:
    """step → the in-band metrics event of that step (``upd_norm/*`` and
    the rest), out of an event stream."""
    return {ev["step"]: {k: v for k, v in ev.items()
                         if "/" in k or k in ("participants", "arrivals")}
            for ev in read_events(path)
            if ev.get("event") == "metrics" and any("/" in k for k in ev)}


def guard_check_specs(tmp: str, r0: dict) -> None:
    """Phase 4b (d): each of ``GUARDED`` on the mesh at its own size, steps
    3-4 on the card from the CPU's step-2 checkpoint: each step line's
    round (arrivals and deadline; faults and the screened clients) equal on
    both devices, the val_loss within ``GUARD_METRIC_TOL``, each field of
    the final state within ``SHARDED_TOL`` of its norm (the faulty spec's
    momenta, which round 1's ×25 sends leave ill-conditioned, only logged:
    ROADMAP queue 3 item 15), and the telemetry spec's in-band metrics of
    both steps within ``GUARD_METRIC_TOL``."""
    fields = ("arrivals", "deadline", "nan", "byzantine", "screened")
    for name in GUARDED:
        cpu, card = r0[f"d_{name}_cpu"], r0[f"d_{name}_cuda"]
        if [h["step"] for h in cpu] != [1, 2, 3, 4] or \
                [h["step"] for h in card] != [3, 4]:
            raise SystemExit(f"phase 4b (d) {name}: steps {cpu} / {card}")
        rounds = [{k: h[k] for k in fields if k in h} for h in cpu[2:]]
        losses = [_rel(g["val_loss"], c["val_loss"])
                  for g, c in zip(card, cpu[2:])]
        if [{k: h[k] for k in fields if k in h} for h in card] != rounds \
                or not max(losses) <= GUARD_METRIC_TOL:
            raise SystemExit(f"phase 4b (d) {name}: rounds card {card}, "
                             f"CPU {cpu[2:]}")
        # the reduced specs' one f32 buffer: a0 the variables, a1 the
        # momenta, then the step and the host fields
        final = [_ckpt_arrays(os.path.join(tmp, f"d-{name}-{dev}"))
                 for dev in ("cuda", "cpu")]
        errs = [_rel(g, c) for g, c in zip(*final)]
        held = [e <= SHARDED_TOL for e in errs]
        if not held[0] or (name != FAULTY and not all(held)) or \
                len(final[0]) != len(final[1]):
            raise SystemExit(f"phase 4b (d) {name}: card against CPU, "
                             f"relative error by field {errs}")
        metrics = ""
        if name == TELEMETRY:
            got, want = (_inband(os.path.join(tmp, f"d-{name}-{dev}",
                                              "events.jsonl"))
                         for dev in ("cuda", "cpu"))
            rel = {k: _rel(got[t][k], want[t][k])
                   for t in (3, 4) for k in want[t]}
            if sorted(got) != [3, 4] or not rel or \
                    not max(rel.values()) <= GUARD_METRIC_TOL:
                raise SystemExit(f"phase 4b (d) {name}: in-band metrics "
                                 f"card {got}, CPU {want}")
            metrics = (f"; in-band metrics of steps 3-4 ({len(rel)}) within "
                       f"{max(rel.values()):.3e} of the CPU's")
        log(f"phase 4b (d): {name}.json on the [4, 2] mesh at its size, "
            f"steps 3-4 on the card from the CPU's step-2 checkpoint: "
            f"rounds {rounds} equal on both devices, val_loss within "
            f"{max(losses):.3e}; relative error by field of the final state "
            f"{[f'{e:.3e}' for e in errs]} (limit {SHARDED_TOL}"
            f"{'; the momenta only logged, queue 3 item 15' if name == FAULTY else ''})"
            f"{metrics}")
    log(f"phase 4b (d) took {r0['d_s']} s")


def _cpu_checks(e: list, name: str, passes: set) -> str:
    """The card-against-CPU records of a (e) run (:func:`_on_cpu_at`), over
    the ranks: every metric pass of ``passes`` ran, each result within
    ``GUARD_METRIC_TOL`` of the CPU's; every guarded mean within
    ``SHARDED_TOL`` of the CPU's, its screen verdicts equal.  Returns the
    log's words for them."""
    rels = [_rel(card, cpu) for x in e for _, res in x["metrics"]
            for card, cpu in res.values()]
    ran = {p for x in e for p, _ in x["metrics"]}
    if ran != passes or not rels or not max(rels) <= GUARD_METRIC_TOL:
        raise SystemExit(f"phase 4b (e) {name}: metric passes {sorted(ran)} "
                         f"(expected {sorted(passes)}) card against CPU "
                         f"{rels}")
    words = (f"{len(rels)} results of the passes {sorted(ran)} over the "
             f"ranks within {max(rels):.3e} of the same passes on CPU "
             f"copies of their inputs")
    guarded = [g for x in e for g in x["guarded"]]
    if not guarded:
        return words
    if not all(g["rel"] <= SHARDED_TOL and g["verdicts"]
               and g["verdicts"][0] == g["verdicts"][1] for g in guarded):
        raise SystemExit(f"phase 4b (e) {name}: the guarded means card "
                         f"against CPU {guarded}")
    return (f"{words}; {len(guarded)} guarded means (screen, z-score, "
            f"{name}'s aggregator) within {max(g['rel'] for g in guarded):.3e} "
            f"of the same on CPU copies (limit {SHARDED_TOL}), verdicts "
            f"equal, {sorted({tuple(g['verdicts'][0]) for g in guarded})}; "
            f"on the card (elements, ms, its gloo collectives in it) by "
            f"rank {[[(g['elems'], g['ms']) for g in x['guarded']] for x in e]}")


def guard_check_full(ranks: list, groups: int) -> dict:
    """Phase 4b (e): the runs of ``FULL_RUNS`` at full width on the card,
    every rank's ``storm3_step`` launches counted (one a dtype buffer a
    step, its tables gated by the round), and with int8 sends the
    ``quantpack``/``quantunpack`` launches of the wire (one pair a buffer
    a reduction) and of the quantization pass; each rank's step ms and
    peak bytes and the reductions' ms through gloo.  The faulty spec:
    round 0's NaN and ×25 sends, every NaN sender screened, no rollback,
    the health screen and the guarded means against CPU copies
    (:func:`_cpu_checks`).  The rollback edit: one rollback on every rank
    (one restore each, to step 1), the host snapshot and restore seconds.
    The telemetry spec with int8 sends: its metric passes, the
    quantization pass among them, against CPU copies.  Returns the
    launches summed over the ranks and the runs."""
    total = {k: 0 for k in ranks[0]["e_straggler"]["launches"]}
    for key, (name, _, steps, _) in FULL_RUNS.items():
        e = [r[f"e_{key}"] for r in ranks]
        lines = e[0]["lines"]
        got = {k: sum(x["launches"][k] for x in e) for k in total}
        want = {k: 0 for k in total}
        want["storm3_step"] = len(ranks) * steps * groups
        if key == "telemetry":
            # the wire packs the variables and momenta of each buffer once;
            # the quantization pass packs its chunks at every step
            packs = len(ranks) * 2 * groups + sum(
                n for x in e for n in x["pass_packs"])
            want.update(quantpack=packs, quantunpack=packs)
        rolled = [json.loads(ln) for ln in e[0]["printed"].splitlines()
                  if ln.startswith('{"rollback_to"')]
        if got != want or not all(math.isfinite(h["val_loss"])
                                  for h in lines) or \
                [h["step"] for h in lines] != [1, 2] or \
                bool(rolled) != (key == "rollback"):
            raise SystemExit(f"phase 4b (e) {key}: launches {got} "
                             f"(expected {want}), lines {lines}, rollbacks "
                             f"{rolled}")
        total = {k: total[k] + got[k] for k in total}
        comm = [[(c["step"] + 1, c["elems"], c["issue_ms"], c["wait_ms"])
                 for c in x["comm"]] for x in e]
        extra = ""
        if key == "straggler":
            extra = (f"; arrivals by step "
                     f"{[h['arrivals'] for h in lines]}, deadlines "
                     f"{[h['deadline'] for h in lines]}")
        if key == "faulty":
            last = lines[-1]
            if not last["nan"] or not last["byzantine"] or \
                    not set(last["nan"]) <= set(last["screened"]):
                raise SystemExit(f"phase 4b (e) {key}: round 0 {last}")
            extra = (f"; round 0 (step 2): NaN from {last['nan']}, ×25 from "
                     f"{last['byzantine']}, screened {last['screened']}; "
                     f"{_cpu_checks(e, key, {'section_norms', 'section_drift', 'health_screen'})}"
                     f"; the reductions through gloo (step, elements, "
                     f"issue ms, wait ms; with the CPU copies) "
                     f"by rank {comm}")
        if key == "rollback":
            restores = [len(x["rollback"].get("restore", [])) for x in e]
            if [(r["rollback_to"], r["retry"]) for r in rolled] != [(1, 1)] \
                    or restores != [1] * len(ranks):
                raise SystemExit(f"phase 4b (e) {key}: rollbacks {rolled}, "
                                 f"restores by rank {restores}")
            extra = (f"; rolled back {rolled} on every rank: snapshot s by "
                     f"rank {[x['rollback']['snapshot'] for x in e]}, "
                     f"restore s by rank "
                     f"{[x['rollback']['restore'] for x in e]}; the plain "
                     f"means (no screen) through gloo (step, elements, "
                     f"issue ms, wait ms) by rank {comm}")
        if key == "telemetry":
            extra = (f"; int8 sends: {_cpu_checks(e, key, set(_METRIC_PASSES) - {'health_screen'})}; "
                     f"the quantization pass's packs "
                     f"{sum(n for x in e for n in x['pass_packs'])}")
        log(f"phase 4b (e): {name}.json ({key}) at full width ({MAIN_LAYERS} "
            f"layers) on the [4, 2] mesh, {steps} steps: launches over the "
            f"ranks {got}; step ms by rank {[x['steps_ms'] for x in e]}; "
            f"peak memory by rank {[x['peak'] for x in e]} B; val_loss "
            f"{[h['val_loss'] for h in lines]}{extra}; {e[0]['s']} s")
    return total


# ---------------------------------------------------------------------------
# phase 5b: the unfused tree path, microbatching and remat
# ---------------------------------------------------------------------------

_HOST_FIELDS = ("step", "stale", "deadline", "retry")


def _tree_to(state, dev):
    """A tree-path train state with its variables and momenta on ``dev``
    (the step and the staleness counters stay on the host)."""
    return state._replace(**{
        f: tree_map(lambda t: t.to(dev), getattr(state, f))
        for f in state._fields if f not in _HOST_FIELDS})


def _field_rel(got, want) -> float:
    """``|got - want| / |want|`` over a field's leaves (0 where both are
    zero: FedBiO-Local's unused u slot)."""
    num = sum(float(((g.cpu().float() - w.float()) ** 2).sum())
              for g, w in zip(tree_leaves(got), tree_leaves(want)))
    den = sum(float((w.float() ** 2).sum()) for w in tree_leaves(want))
    return (num / den) ** 0.5 if den else (0.0 if num == 0 else math.inf)


def tree_cross_check(name: str, exp: Experiment, dev) -> None:
    """Two rounds of the reduced tree path on the card against the CPU
    from the same initial state and batches."""
    cpu_run = build(exp, device="cpu")
    gpu_run = build(exp, device=dev)
    cpu_state = cpu_run.init(torch.Generator().manual_seed(0))
    gpu_state = _tree_to(cpu_state, dev)
    data = torch.Generator().manual_seed(1)
    reset_counts()
    for _ in range(2 * exp.schedule.local_steps):
        batch = cpu_run.batch_fn(data)
        cpu_state, _ = cpu_run.step(cpu_state, batch)
        gpu_state, _ = gpu_run.step(gpu_state, tree_map(lambda v: v.to(dev),
                                                        batch))
    fields = [f for f in cpu_state._fields if f not in _HOST_FIELDS
              and tree_leaves(getattr(cpu_state, f))]
    errs = {f: _field_rel(getattr(gpu_state, f), getattr(cpu_state, f))
            for f in fields}
    worst = max(errs.values())
    on_card = {f: all(t.device.type == "cuda" for t in
                      tree_leaves(getattr(gpu_state, f))) for f in fields}
    log(f"tree path, {name}: card vs CPU after 2 rounds (pod-local, "
        f"global; 2 of 4 clients a round), relative difference by field "
        f"{ {f: float(f'{e:.3e}') for f, e in errs.items()} } (limit "
        f"{TREE_TOL}), launches {launch_counts()}")
    if not (worst <= TREE_TOL and all(on_card.values())
            and not any(launch_counts().values())):
        raise SystemExit(f"tree path cross-check of {name} failed")


def _cuda_timed(events: list):
    """A ``train_cli.build`` hook: the run's steps each between two CUDA
    events, appended to ``events``."""
    def hook(run):
        step = run.step

        @functools.wraps(step)
        def stepped(state, batch):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = step(state, batch)
            end.record()
            events.append((start, end))
            return out
        return run._replace(step=stepped)
    return hook


def tree_cli_path(dev) -> None:
    """``fedbioacc.json`` edited to the tree path at full width through
    the train CLI in process: timed, no engine kernel, stopped after its
    step-2 checkpoint and resumed bit for bit."""
    exp = full_width_experiment(Experiment.load(os.path.join(
        ROOT, "experiments", "fedbioacc.json"))).edit(
            **{"execution.fuse_storm": False})
    common = ["--device", "cuda", "--log-every", "1", "--ckpt-every", "2"]
    strip = lambda hs: [{k: v for k, v in h.items()  # noqa: E731
                         if k != "wall_s"} for h in hs]
    events = []

    def crash(code):
        raise SystemExit(code)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tree_") as tmp:
        spec, whole, crashed = (os.path.join(tmp, f) for f in
                                ("spec.json", "whole", "crashed"))
        exp.save(spec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        # the uninterrupted run is held to the others at its end only
        full = _cli_in_process(["--experiment", spec, "--ckpt-dir", whole,
                                *common[:-1], "4"], _cuda_timed(events))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        step_ms = [round(s.elapsed_time(e), 3) for s, e in events]
        exit_ = os._exit
        os._exit = crash
        try:
            train_cli.main(["--experiment", spec, "--ckpt-dir", crashed,
                            "--crash-at-step", "2", *common])
            code = 0
        except SystemExit as e:
            code = e.code
        finally:
            os._exit = exit_
        resumed = train_cli.main(["--resume", crashed, "--ckpt-dir", crashed,
                                  *common])
        launches = launch_counts()
        mine, want = _final_arrays(crashed), _final_arrays(whole)
        same = (code == 17 and strip(resumed) == strip(full)[2:]
                and len(mine) == len(want) and all(
                    a.dtype == b.dtype and np.array_equal(
                        np.atleast_1d(a).view(np.uint8),
                        np.atleast_1d(b).view(np.uint8))
                    for a, b in zip(mine, want)))
        with open(os.path.join(whole, "manifest.json")) as fh:
            state_kind = json.load(fh)["treedef"].split("[", 1)[1].split("]")[0]
        ev, eval_s = _evaluate_tree_state(exp, whole, dev)
    val = [h["val_loss"] for h in full]
    log(f"tree path, fedbioacc.json with fuse_storm false at full width "
        f"({MAIN_LAYERS} layers, {exp.problem.num_clients} clients) "
        f"through the train CLI: state {state_kind}, step ms {step_ms} "
        f"(CUDA events), {run_s:.1f} s for the run, peak memory {peak} B, "
        f"val_loss {val}; stopped after the step-2 checkpoint (exit {code}) "
        f"and resumed: steps {[h['step'] for h in resumed]} and the final "
        f"checkpoint's {len(want)} arrays "
        f"{'bit for bit' if same else 'NOT'} the uninterrupted run's; "
        f"launches over the three runs {launches}, on {card_line()}")
    m = exp.problem.num_clients
    log(f"eval_federated on the uninterrupted run's final state ({m} "
        f"clients, {eval_s:.3f} s): {ev}")
    if not (len(ev["val_loss_per_client"]) == m and all(
            math.isfinite(v) for k, v in ev.items() if k.endswith("_mean"))
            and all(math.isfinite(v) for v in ev["val_loss_per_client"])):
        raise SystemExit("eval_federated on the tree path's state failed")
    if not (same and state_kind == "FedBiOAccTrainState"
            and all(math.isfinite(v) for v in val)
            and not any(launches.values()) and len(step_ms) == 4):
        raise SystemExit("tree path through the train CLI failed")


def _evaluate_tree_state(exp: Experiment, ckpt: str, dev) -> tuple:
    """``federation.evaluate.eval_federated`` on the tree state saved in
    ``ckpt``, loaded into a fresh build of ``exp`` on the card, on the
    validation stream of the build's fixed evaluation seed; returns (its
    metrics, its seconds between synchronizations)."""
    from repro_torch.api.build import EVAL_SEED
    run = build(exp, device=dev)
    state = load_checkpoint(ckpt, run.init(torch.Generator(
        device=dev).manual_seed(exp.schedule.seed)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = eval_federated(run.model, state, run.batch_fn,
                        torch.Generator().manual_seed(EVAL_SEED),
                        num_clients=exp.problem.num_clients)
    torch.cuda.synchronize()
    return ev, time.perf_counter() - t0


def _micro_run(exp: Experiment, dev) -> tuple:
    """Two full-width steps of ``exp``: (its buffers on the host, step ms,
    peak bytes, launches, val loss)."""
    run = build(exp, device=dev)
    state = run.init(torch.Generator(device=dev).manual_seed(
        exp.schedule.seed))
    data = torch.Generator().manual_seed(exp.schedule.seed)
    batches = [run.batch_fn(data) for _ in range(exp.schedule.steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    events = []
    step = _cuda_timed(events)(run).step
    for batch in batches:
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    out = ([b.cpu() for b in state.vars + state.mom],
           [round(s.elapsed_time(e), 3) for s, e in events],
           torch.cuda.max_memory_allocated(dev), launch_counts(),
           run.eval_fn(state))
    del run, state, batches, step
    torch.cuda.empty_cache()
    return out


def micro_remat_path(dev) -> dict:
    """``fedbioacc.json`` at full width with ``n_micro`` 2, with remat and
    without: the two runs' buffers bit for bit.  Returns the launches of
    both runs."""
    base = full_width_experiment(Experiment.load(os.path.join(
        ROOT, "experiments", "fedbioacc.json"))).edit(**MICRO_EDITS)
    on, off = (_micro_run(base.edit(**{"execution.remat": r}), dev)
               for r in (True, False))
    same = all(same_bits(a, b) for a, b in zip(on[0], off[0]))
    note = "bit for bit"
    if not same:
        # a repeat that differs too says an operation is not deterministic
        again = _micro_run(base.edit(**{"execution.remat": False}), dev)
        worst = max(float((a.float() - b.float()).norm() / b.float().norm())
                    for a, b in zip(on[0], off[0]))
        repeat = all(same_bits(a, b) for a, b in zip(again[0], off[0]))
        note = (f"NOT bit for bit (worst relative {worst:.3e}); a remat-free "
                f"repeat is {'' if repeat else 'NOT '}bit for bit")
        if repeat or not worst <= 1e-4:
            raise SystemExit(f"n_micro 2: remat changed the result: {note}")
    want = {**dict.fromkeys(on[3], 0), "storm3_step": 2 * base.schedule.steps}
    log(f"n_micro 2 over {base.problem.per_client} sequences a client, "
        f"fedbioacc.json at full width ({MAIN_LAYERS} layers, "
        f"{base.problem.num_clients} clients): remat "
        f"on step ms {on[1]}, peak {on[2]} B, val_loss {on[4]}; remat off "
        f"step ms {off[1]}, peak {off[2]} B, val_loss {off[4]}; buffers "
        f"{note}; launches {on[3]} / {off[3]}")
    if on[3] != want or off[3] != want or not math.isfinite(on[4]):
        raise SystemExit(f"n_micro 2 paths launched {on[3]} / {off[3]}, "
                         f"expected {want}")
    return {k: on[3][k] + off[3][k] for k in on[3]}


def tree_path_phase(dev) -> dict:
    """Phase 5b; returns the launches of its full-width paths."""
    t0 = time.perf_counter()
    for algo in TREE_ALGOS:
        exp = Experiment.load(os.path.join(ROOT, "experiments",
                                           f"{algo}.json")).edit(**TREE_EDITS)
        tree_cross_check(algo, exp, dev)
    t1 = time.perf_counter()
    with _depth(MAIN_LAYERS):
        tree_cli_path(dev)
        torch.cuda.empty_cache()
        launches = micro_remat_path(dev)
    log(f"phase 5b took {time.perf_counter() - t0:.1f} s ((a) "
        f"{t1 - t0:.1f} s)")
    return launches


# ---------------------------------------------------------------------------
# phase 4c: the static verifier (repro_torch.analysis) on the card
# ---------------------------------------------------------------------------

ANALYSIS_TIMEOUT = 600.0     # seconds its processes may take
# beside phase 4 every core is taken: the examples' small host-side tensor
# work gets one thread (idle intra-op threads spin), which halved their
# time on the card (my chip runs, PR 29)
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
ANALYSIS_SEED_ELEMS = 7      # the seeded extra all-reduce's f32 elements


def _start_session(args: list, env: dict | None = None) -> subprocess.Popen:
    """Start ``python *args`` from the checkout in a session of its own (it
    may spawn ranks), with ``env`` added to the environment."""
    return subprocess.Popen(
        [sys.executable, *args], cwd=ROOT, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
             "PYTHONFAULTHANDLER": "1", **(env or {})})


def _run_session(args: list, timeout: float, env: dict | None = None,
                 proc: subprocess.Popen | None = None
                 ) -> subprocess.CompletedProcess:
    """Wait for ``python *args`` (started here, or ``proc`` when given)
    for ``timeout`` seconds, past which its session is killed whole."""
    if proc is None:
        proc = _start_session(args, env)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        # each Python process of the session prints its threads' stacks on
        # SIGABRT (PYTHONFAULTHANDLER) before the session is killed
        for sig in (signal.SIGABRT, signal.SIGKILL):
            try:
                os.killpg(proc.pid, sig)
            except ProcessLookupError:
                break
            time.sleep(10)
        out, err = proc.communicate()
        raise SystemExit(f"{args} still running after {timeout} s:\n"
                         f"{out[-3000:]}\n{err[-20000:]}")
    return subprocess.CompletedProcess(args, proc.returncode, out, err)


def _seeded_w101(store: str, out: str) -> None:
    """A 1-rank world at mesh (1, 1) on the card: ``fedbioacc_local.json``
    with one extra f32 all-reduce on the data group wrapped into its step
    (``testing.seeded_all_reduce``); writes the collective audit's findings
    to ``out`` and exits 1 when there are any, as the verifier's CLI
    does."""
    import torch.distributed as dist

    from repro_torch.analysis import collectives as coll
    from repro_torch.launch.mesh import init_ranks
    torch.set_num_threads(1)
    init_ranks(0, 1, store)
    run = build(Experiment.load(os.path.join(
        ROOT, "experiments", "fedbioacc_local.json")).edit(
            **{"execution.mesh": (1, 1)}), device="cuda")
    findings = coll.audit_step_collectives(
        seeded_all_reduce(run, ANALYSIS_SEED_ELEMS))
    with open(out, "w") as fh:
        json.dump([list(f) for f in findings], fh)
    dist.destroy_process_group()
    sys.exit(1 if findings else 0)


def analysis_phase() -> None:
    """Phase 4c, right after phase 2, alone on the card: ``python -m
    repro_torch.analysis --all experiments/ --lint src/repro_torch`` on the
    card must exit 0 with an OK line for each committed spec, the sharded
    spec's audited on its 8 gloo ranks on ``cuda:0`` with ``storm3_step``
    calls in its recorded step; then the seeded variant must exit 1 with
    W101 alone."""
    t0 = time.perf_counter()
    specs = sorted(f for f in os.listdir(os.path.join(ROOT, "experiments"))
                   if f.endswith(".json"))
    out = _run_session(["-m", "repro_torch.analysis", "--all",
                        "experiments/", "--lint", "src/repro_torch"],
                       ANALYSIS_TIMEOUT)
    lines = out.stdout.splitlines()
    ok = [ln for ln in lines if ln.startswith("OK experiments/")]
    sharded = [ln for ln in ok if "fedbioacc_sharded_overlap" in ln]
    for ln in lines:
        log(f"analysis: {ln}")
    if (out.returncode != 0 or len(ok) != len(specs)
            or "lint src/repro_torch: OK" not in lines
            or not sharded or "storm3_step=" not in sharded[0]):
        raise SystemExit(f"phase 4c: the verifier exited {out.returncode} "
                         f"with {len(ok)} OK lines of {len(specs)} specs:\n"
                         f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    t1 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_analysis_")
    found = os.path.join(tmp, "findings.json")
    child = multiprocessing.get_context("spawn").Process(
        target=_seeded_w101, args=(os.path.join(tmp, "store"), found))
    child.start()
    child.join(ANALYSIS_TIMEOUT)
    if child.exitcode is None:
        child.kill()
        child.join()
    findings = []
    if os.path.isfile(found):
        with open(found) as fh:
            findings = json.load(fh)
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"analysis: the seeded variant (fedbioacc_local at (1, 1), an extra "
        f"{ANALYSIS_SEED_ELEMS}-element f32 all_reduce on the data group) "
        f"exited {child.exitcode}: {findings}")
    if child.exitcode != 1 or {f[0] for f in findings} != {"W101"}:
        raise SystemExit("phase 4c: the seeded variant did not exit 1 with "
                         "W101 alone")
    log(f"phase 4c (the verifier on the card) took "
        f"{time.perf_counter() - t0:.1f} s, alone after phase 2: the CLI "
        f"over "
        f"{len(specs)} specs {t1 - t0:.1f} s, the seeded variant "
        f"{time.perf_counter() - t1:.1f} s")


# ---------------------------------------------------------------------------
# phase 4d: the dry run
# ---------------------------------------------------------------------------

DRYRUN_ARCH = "mamba2-130m"
DRYRUN_SHAPES = ("prefill_32k", "decode_32k")
# the grid's train kind: llama3-405b's deployment (2 clients, FedBiO, 16
# microbatches) traces in a fraction of mamba2-130m's (16 clients,
# FedBiOAcc, 4 microbatches: 394.3 s at 1 layer on the H100's host), as
# the tree path loops over clients and microbatches on the host
DRYRUN_TRAIN = ("llama3-405b", "train_4k")
PEAK_TOL = 0.10              # predicted peak against the real step's
SPECS = ("fedbioacc", "fedbio", "fedbio_local", "fedavg", COMPRESSED,
         SAMPLED, STRAGGLED, FAULTY, TELEMETRY, SHARDED)


def _entries_json(counter) -> list:
    return [[list(e), k] for e, k in sorted(counter.items())]


def _entries(rows: list) -> dict:
    return {(e[0], tuple(e[1]), e[2], e[3], e[4]): k for e, k in rows}


def _brief(rec: dict) -> str:
    """A dry-run record on one line: what it sized and what it cost."""
    keep = ("status", "kind", "trace_s", "trace_ops", "kernels", "memory",
            "cost", "per_device_argument_bytes", "mesh", "n_micro",
            "remat_layers", "compression_check")
    out = {k: rec[k] for k in keep if k in rec}
    coll = rec.get("collectives")
    if coll:
        out["collectives"] = {"total_bytes": coll["total_bytes"],
                              "counts": {k: v for k, v in
                                         coll["counts"].items() if v},
                              "bytes_by_dtype": coll["bytes_by_dtype"]}
    return json.dumps(out)


def _fedbioacc_full() -> Experiment:
    return full_width_experiment(Experiment.load(os.path.join(
        ROOT, "experiments", "fedbioacc.json")))


def _grid_one(arch: str, shape: str, **kw) -> None:
    rec = dryrun.run_one(arch, shape, device="cuda", **kw)
    if rec["status"] != "OK":
        raise SystemExit(f"dry run of {arch} × {shape} {kw}: {rec}")
    log(f"dry run (c) {arch} × {shape}{' ' + str(kw) if kw else ''} at "
        f"{MAIN_LAYERS} layer(s): {_brief(rec)}")


def dryrun_specs() -> float:
    """Phase 4d (a), in a child process of its own beside phases 5–9 (it
    allocates nothing on the card): the ten committed specs on CUDA fakes
    (the sharded one on rank 0 of a fake group of 8).  Returns the
    seconds."""
    t0 = time.perf_counter()
    torch.cuda.init()
    held = torch.cuda.memory_allocated()
    for name in SPECS:
        path = os.path.join(ROOT, "experiments", f"{name}.json")
        rec = dryrun.run_experiment(path, device="cuda")
        if rec["status"] != "OK":
            raise SystemExit(f"dry run of {name}: {rec}")
        if name == SHARDED and rec.get("mesh") != dict(zip(
                ("data", "model"), SHARDED_MESH)):
            raise SystemExit(f"dry run of {name} on no fake mesh: {rec}")
        if name == COMPRESSED and rec["compression_check"] != \
                "unsharded: no collectives to audit":
            raise SystemExit(f"dry run of {name}: {rec['compression_check']}")
        log(f"dry run (a) {name}: {_brief(rec)}")
    if torch.cuda.memory_allocated() != held:
        raise SystemExit(f"the dry runs allocated on the card: "
                         f"{torch.cuda.memory_allocated() - held} B")
    return time.perf_counter() - t0


def dryrun_checks() -> dict:
    """Phase 4d's other traces, in a second child beside phases 5–9: (b)'s
    trace of the full-width ``fedbioacc.json``; (c) the grid arch's
    prefill and decode and ``DRYRUN_TRAIN``; (d) the full-width sharded
    spec phase 4b ran, on a fake group of 8, and the fused mesh ``4,2`` of
    the grid arch.  Checks that no trace allocated on the card; returns
    (b)'s record, (d)'s collectives and the seconds."""
    t0 = time.perf_counter()
    torch.cuda.init()
    held = torch.cuda.memory_allocated()
    sharded_spec = _sharded_specs(tempfile.mkdtemp(
        prefix="chip_smoke_dryrun_"))["b"]
    with _depth(MAIN_LAYERS):
        full, _ = dryrun.trace_experiment(_fedbioacc_full(), "cuda")
        full = {k: full[k] for k in ("memory", "cost", "kernels")}
        log(f"dry run (b) fedbioacc at full width, {MAIN_LAYERS} layer(s), "
            f"{time.perf_counter() - t0:.1f} s: {json.dumps(full)}")
        for shape in DRYRUN_SHAPES:
            _grid_one(DRYRUN_ARCH, shape)
        out, _ = dryrun.trace_experiment(Experiment.load(sharded_spec),
                                         "cuda")
        log(f"dry run (d) {SHARDED} at full width on a fake group of 8: "
            f"{_brief(out)}")
        _grid_one(DRYRUN_ARCH, "train_4k", fused_mesh=SHARDED_MESH)
        _grid_one(*DRYRUN_TRAIN)
    if torch.cuda.memory_allocated() != held:
        raise SystemExit(f"the dry runs allocated on the card: "
                         f"{torch.cuda.memory_allocated() - held} B")
    return {"full": full, "entries": _entries_json(out["_entries"]),
            "s": time.perf_counter() - t0}


def _device_bytes(tree) -> int:
    """The bytes of the distinct card storages in ``tree``."""
    seen = {}
    for t in dryrun._tensors(tree):
        if t.is_cuda:
            seen[t.untyped_storage().data_ptr()] = \
                t.untyped_storage().nbytes()
    return sum(seen.values())


def dryrun_path(dev) -> tuple:
    """Phase 4d (b)'s real side: the step the second child traces
    (``fedbioacc.json`` at full width, ``MAIN_LAYERS`` layers) run once
    on the card.  Returns its launches and what :func:`dryrun_compare`
    holds the trace to: ``FlopCounterMode`` over the step plus the
    launched kernels' work, the state's and batch's storages on the card,
    the outputs', and the step's ``max_memory_allocated()`` increase."""
    from torch.utils.flop_counter import FlopCounterMode
    with _depth(MAIN_LAYERS):
        run = build(_fedbioacc_full(), device=dev)
        state = run.init(torch.Generator(device=dev).manual_seed(0))
        state = state._replace(step=run.spec.schedule.local_steps - 1)
        batch = run.place_batch(run.batch_fn(
            torch.Generator().manual_seed(0)))
        args = _device_bytes((state, batch))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        counter = FlopCounterMode(display=False)
        with counter:
            new, _ = run.step(state, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        launches = launch_counts()
        m = run.spec.problem.num_clients
        kernel_flops = sum(storm.work("storm3_step", m * g.padded, g.dtype,
                                      block=g.block).flops
                           for g in run.step.spec.groups)
        if launches["storm3_step"] != len(run.step.spec.groups):
            raise SystemExit(f"dry run (b): the real step launched "
                             f"{launches}")
        measured = {"aten_flops": counter.get_total_flops(),
                    "kernel_flops": kernel_flops,
                    "launches": launches["storm3_step"], "args": args,
                    "outputs": _device_bytes(new), "peak": peak}
    del state, batch, new
    torch.cuda.empty_cache()
    return launches, measured


def dryrun_compare(traced: dict, real: dict) -> None:
    """Phase 4d (b): FLOPs equal, argument bytes equal, the predicted
    peak within ``PEAK_TOL`` of the measured one, the gap's cause
    printed."""
    mem = traced["memory"]
    flops = real["aten_flops"] + real["kernel_flops"]
    pred, peak = mem["temp_size_in_bytes"], real["peak"]
    gap = (pred - peak) / peak
    log(f"dry run (b) against the real step: FLOPs "
        f"{traced['cost']['flops']:.0f} traced, {flops} real "
        f"({real['aten_flops']} ATen + {real['kernel_flops']} in "
        f"{real['launches']} storm3_step); argument bytes "
        f"{mem['argument_size_in_bytes']} traced, {real['args']} real; "
        f"output bytes {mem['output_size_in_bytes']} traced, "
        f"{real['outputs']} real; peak above the arguments {pred} B "
        f"predicted, {peak} B measured ({gap:+.2%}: the dry run counts each "
        f"storage while a tensor holds it, the caching allocator its "
        f"blocks as they are handed out and back)")
    if traced["cost"]["flops"] != float(flops):
        raise SystemExit("dry run (b): the traced FLOPs differ from the "
                         "real step's")
    if mem["argument_size_in_bytes"] != real["args"]:
        raise SystemExit("dry run (b): the traced argument bytes differ from "
                         "the real state's and batch's")
    if abs(gap) > PEAK_TOL:
        raise SystemExit(f"dry run (b): the predicted peak is {gap:+.2%} "
                         f"from the measured one")


def dryrun_collectives_check(traced: list, ranks: list) -> None:
    """Phase 4d (d): the collectives rank 0 of the fake group issued in its
    trace of round 1's communication step are the multiset 4b's rank 0
    recorded on gloo for the same step."""
    got, want = _entries(traced), _entries(ranks)
    if got != want:
        raise SystemExit(f"dry run (d): the fake group's collectives "
                         f"{got} differ from phase 4b's {want}")
    log(f"dry run (d): the fake group of 8 issued phase 4b's multiset, "
        f"{sum(got.values())} collectives in {len(got)} kinds")


# ---------------------------------------------------------------------------
# phases 6 to 8: the model kernels and the serving path
# ---------------------------------------------------------------------------

def _entry(name: str, source: str, replaces: str, err: float, ms: float,
           plain_ms: float, moved: int, ops_ms: float, library_ms) -> dict:
    """A kernel's line: its bound is the larger of the bytes these inputs
    and outputs take over the memory rate and ``ops_ms``, its operations
    each over the peak rate of their type."""
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


def lru_phase(dev) -> dict:
    """The RG-LRU scan at the serving path's shape, [batch, prompt, LRU
    width] f32 without h0 (as a prefill calls it), bit for bit; then an odd
    shape with h0."""
    gen = torch.Generator(device=dev).manual_seed(2)
    shape = (SERVE_BATCH, SERVE_PROMPT, get_config(SERVE_ARCH).resolved_lru_width)
    a = 0.7 + 0.299 * torch.rand(shape, generator=gen, device=dev)
    b = 0.1 * torch.randn(shape, generator=gen, device=dev)
    lru_ops.reset_counts()
    out, want = lru_ops.lru_scan(a, b), lru_scan_ref(a, b)
    torch.cuda.synchronize()
    variant = [k for k, v in lru_ops.VARIANTS.items() if v]
    if not same_bits(out, want) or variant != ["lru_scan_tma"]:
        raise SystemExit(f"lru_scan: {variant} differs from the plain "
                         f"version at {list(shape)}, or is not the TMA "
                         f"kernel")
    err = float((out - want).abs().max())
    odd = {}
    for B, S, C in ((2, 1001, 77), (2, 1000, 100)):
        oa, ob = (t[:B, :S, :C].contiguous() for t in (a, b))
        h0 = torch.randn(B, C, generator=gen, device=dev)
        lru_ops.reset_counts()
        if not same_bits(lru_ops.lru_scan(oa, ob, h0),
                         lru_scan_ref(oa, ob, h0)):
            raise SystemExit(f"lru_scan: kernel differs from the plain "
                             f"version at {[B, S, C]} with h0")
        odd[f"{[B, S, C]}"] = [k for k, v in lru_ops.VARIANTS.items() if v]
    work = lru_ops.work(*shape)
    moved = work.bytes
    lanes_ms = raw_ms("lru_scan_lanes", lru_ops._lib(), a.data_ptr(),
                      b.data_ptr(), None, out.data_ptr(), *shape)
    del out, want, oa, ob
    k_ms = timed_ms(lambda: lru_ops.lru_scan(a, b), KERNEL_RUNS)
    p_ms = timed_ms(lambda: lru_scan_ref(a, b), 3)
    entry = _entry("lru_scan", "src/repro_torch/kernels/csrc/lru_scan.cu",
                   "src/repro/kernels/lru/kernel.py:48", err, k_ms, p_ms,
                   moved, work.flops / F32_FLOPS_PER_S * 1e3, None)
    log(f"lru_scan f32 {list(shape)} (serving path, per rec layer; "
        f"{variant[0]}): bitwise equal (and with h0 at {odd}), kernel "
        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, {moved} B, bound "
        f"{entry['bound_ms']:.4f} ms ({moved / k_ms / 1e6:.1f} GB/s, "
        f"{entry['bound_ms'] / k_ms:.1%} of the bound); the lanes kernel on "
        f"the same inputs {lanes_ms:.4f} ms")
    log("lru_scan: library none: no single PyTorch call computes a linear "
        "recurrence")
    return entry


def flash_phase(dev) -> dict:
    """The attention at the serving path's shapes (one local layer's
    prefill) in bf16 and f32, and a window-0, soft-capped GQA case in each,
    within the reference's kernel-test tolerances; in bf16 also within
    ``BF16_ULPS`` bf16 ulps of the plain version, a limit that two plain
    versions with a kernel's fault (p rounded to bf16 before p.v, a key
    tile skipped) must break in the same cases; times at the path's bf16,
    beside SDPA with the band as a boolean mask."""
    cfg = get_config(SERVE_ARCH)
    B, S, H, hkv, D = (SERVE_BATCH, SERVE_PROMPT, cfg.num_heads,
                       cfg.num_kv_heads, cfg.resolved_head_dim)
    kw = dict(causal=cfg.causal, window=cfg.window_size,
              softcap=cfg.attn_softcap, scale=1.0 / math.sqrt(D))
    gen = torch.Generator(device=dev).manual_seed(3)
    path = (torch.randn(B, S, H, D, generator=gen, device=dev),
            *(torch.randn(B, S, hkv, D, generator=gen, device=dev)
              for _ in range(2)))
    capped = (torch.randn(1, 1000, 8, 128, generator=gen, device=dev),
              *(torch.randn(1, 1000, 2, 128, generator=gen, device=dev)
                for _ in range(2)))
    cap_kw = dict(causal=True, window=0, softcap=50.0)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for what, ins, kwargs in (("path", path, kw), ("capped", capped,
                                                       cap_kw)):
            args = tuple(t.to(dtype) for t in ins)
            got = flash_ops.flash_attention(*args, **kwargs)
            want = flash_attention_ref(*args, **kwargs)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            note = ""
            if dtype == torch.bfloat16:
                # the exact split's claim: the kernel's f32 output is the
                # reference's to f32 rounding, so the two bf16 roundings
                # differ by at most an ulp; each fault breaks that
                ulps = bf16_ulps(got, want)
                faults = {f: bf16_ulps(flash_attention_fault(
                    *args, f, **kwargs), want) for f in ("p0", "tile")}
                note = (f", {ulps:.4g} bf16 ulps (limit {BF16_ULPS}, floor "
                        f"{BF16_FLOOR}; faults: p0 only {faults['p0']:.4g}, "
                        f"a key tile skipped {faults['tile']:.4g})")
                if not ulps <= BF16_ULPS:
                    raise SystemExit(f"flash_attention is more than "
                                     f"{BF16_ULPS} bf16 ulps from the plain "
                                     f"version ({what})")
                if not min(faults.values()) > BF16_ULPS:
                    raise SystemExit(f"the bf16 ulp check passes a faulty "
                                     f"plain version ({what}: {faults})")
            log(f"flash_attention {str(dtype).replace('torch.', '')} {what} "
                f"{[list(t.shape) for t in args]} {kwargs}: max abs err "
                f"{err:.3e} (limit {FLASH_TOL[dtype]}){note}")
            if not err <= FLASH_TOL[dtype]:
                raise SystemExit(f"flash_attention differs from the plain "
                                 f"version ({dtype}, {what})")
            errs[dtype, what] = err
            del got, want, args
            torch.cuda.empty_cache()
    q, k, v = (t.to(torch.bfloat16) for t in path)
    del path, capped
    want = flash_attention_ref(q, k, v, **kw)
    out = flash_ops.flash_attention(q, k, v, **kw)
    mask = band_mask(S, causal=kw["causal"], window=kw["window"], device=dev)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=kw["scale"], enable_gqa=True)

    lib_out = library().transpose(1, 2)
    lib_err = float((lib_out.float() - want.float()).abs().max())
    lib_ulps = bf16_ulps(lib_out, want)
    del lib_out
    if not lib_err <= FLASH_TOL[torch.bfloat16]:
        raise SystemExit(f"the library call differs from the plain version "
                         f"({lib_err})")
    work = flash_ops.work(B, S, H, hkv, D, q.dtype, causal=kw["causal"],
                          window=kw["window"])
    moved = work.bytes
    # each (query, key) pair in the band costs D multiply-adds for q.k and D
    # for p.v.  q.k multiplies bf16 inputs, whose products f32 holds
    # exactly, so bf16 tensor cores compute the reference's products; p.v
    # multiplies the f32 p by bf16 v, and p splits exactly into three bf16
    # terms (p0 = bf16(p), p1 = bf16(p - p0), p2 = bf16(p - p0 - p1)), each
    # of whose products with v f32 holds exactly: one q.k and three p.v
    # products at the bf16 tensor-core rate.  (Pricing p.v at the f32 rate,
    # as before the tensor-core kernel, is logged for comparison.)
    pairs = int(mask.sum())
    half = work.flops // 4
    ops_ms = work.flops / BF16_TC_FLOPS_PER_S * 1e3
    old_ms = (half / BF16_TC_FLOPS_PER_S + half / F32_FLOPS_PER_S) * 1e3
    del want, out
    torch.cuda.empty_cache()
    k_ms = timed_ms(lambda: flash_ops.flash_attention(q, k, v, **kw),
                    KERNEL_RUNS)
    p_ms = timed_ms(lambda: flash_attention_ref(q, k, v, **kw), 3)
    l_ms = timed_ms(library, KERNEL_RUNS)
    entry = _entry("flash_attention",
                   "src/repro_torch/kernels/csrc/flash_attn.cu",
                   "src/repro/kernels/flash/kernel.py:91",
                   errs[torch.bfloat16, "path"], k_ms, p_ms, moved, ops_ms,
                   l_ms)
    log(f"flash_attention bf16 q {list(q.shape)} kv {list(k.shape)} causal "
        f"window {kw['window']} (serving path, per local layer; "
        f"flash_fwd_tc): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
        f"(SDPA, boolean band mask, enable_gqa; max abs err {lib_err:.3e}, "
        f"{lib_ulps:.4g} bf16 ulps) "
        f"{l_ms:.4f} ms; {pairs} (query, key) pairs per head, {half} "
        f"operations a product, one q.k and three p.v (the exact bf16 split "
        f"of p) at the bf16 tensor-core rate, {moved} B: bound "
        f"{entry['bound_ms']:.4f} ms by {entry['bound_by']} "
        f"({entry['bound_ms'] / k_ms:.1%} of it; {4 * half / k_ms / 1e9:.2f} "
        f"TFLOP/s of tensor-core work); the earlier pricing (q.k at the "
        f"bf16 rate, p.v at the f32 rate) {old_ms:.4f} ms")
    return entry


def _kernel_layers(cfg) -> dict:
    """What one prefill of ``cfg`` launches: the attention kernel once per
    attention layer, the scan once per recurrent one."""
    kinds = cfg.layer_kinds()
    return {"flash_attention": sum(k in ("local", "attn") for k in kinds),
            "lru_scan": kinds.count("rec")}


def serve_cross_check(dev, arch: str) -> float:
    """A reduced arch (f32; RecurrentGemma's 3 layers, the others' 2): prompt
    100 (ragged tiles; the reduced window of 64 bites; a VLM's 8 patches
    before it) and 8 teacher-forced decode steps, on the card through the
    kernels and on the CPU through their plain versions, from the same
    params; the audio encoder (no decode step): the forward's logits over
    100 frames.  Returns the worst logit difference, relative to the
    largest logit."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, dtype=torch.float32)
    B, S, gen = 2, 100, 8
    host = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (B, S + gen), generator=host)
    extra, offset = {}, 0
    if cfg.family == "vlm":
        extra["patches"] = 0.1 * torch.randn(
            (B, cfg.num_patches, cfg.frontend_dim), generator=host)
        offset = cfg.num_patches
    frames = torch.randn((B, S, cfg.frontend_dim), generator=host) \
        if cfg.family == "audio" else None
    cpu_params = model.init(torch.Generator().manual_seed(0))
    steps = {}
    reset_counts()
    with torch.no_grad():
        for side, d in (("cpu", torch.device("cpu")), ("card", dev)):
            params = tree_map(lambda t: t.to(d), cpu_params)
            if frames is not None:
                steps[side] = [model.forward(params, {"frames": frames.to(d)},
                                             use_flash=True)[0].cpu()]
                continue
            t = tok.to(d)
            batch = {"tokens": t[:, :S],
                     **{k: v.to(d) for k, v in extra.items()}}
            last, caches = model.prefill(params, batch,
                                         cache_len=offset + S + gen,
                                         use_flash=True, use_lru_kernel=True)
            steps[side] = [last.cpu()]
            for i in range(gen):
                last, caches = model.decode_step(
                    params, caches, t[:, S + i:S + i + 1], offset + S + i)
                steps[side].append(last.cpu())
    launches = launch_counts()
    want = {**dict.fromkeys(launches, 0), **_kernel_layers(cfg)}
    if launches != want:
        raise SystemExit(f"reduced serving cross-check ({arch}) launched "
                         f"{launches}, expected {want}")
    worst = max(float((g - c).abs().max() / c.abs().max())
                for g, c in zip(steps["card"], steps["cpu"]))
    what = (f"forward over {S} frames" if frames is not None else
            f"prefill {offset} patches + {S} + {gen} decode steps")
    log(f"reduced serving cross-check {arch} ({cfg.family}, "
        f"{cfg.num_layers} layers, f32): card (kernels: "
        f"{ {k: v for k, v in launches.items() if v} }) vs CPU (plain "
        f"versions), {what}, worst logit difference {worst:.3e} of the "
        f"largest (limit 1e-4)")
    if not worst <= 1e-4:
        raise SystemExit(f"reduced serving cross-check failed ({arch})")
    return worst


def serving_path(dev) -> dict:
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    out = serve.main(["--arch", SERVE_ARCH, "--batch", str(SERVE_BATCH),
                      "--prompt-len", str(SERVE_PROMPT), "--gen",
                      str(SERVE_GEN), "--seed", "0"])
    launches, variants = launch_counts(), variant_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"serving path: full-width {SERVE_ARCH}, bf16, batch {SERVE_BATCH}, "
        f"prompt {SERVE_PROMPT}, {SERVE_GEN} tokens: prefill "
        f"{out['prefill_ms']:.3f} ms, decode {out['decode_ms_per_step']:.3f} "
        f"ms per step ({SERVE_BATCH} tokens), peak memory {peak} B, "
        f"launches {launches}, scans by kernel {lru_ops.VARIANTS}")
    want = {**dict.fromkeys(launches, 0), **SERVE_LAUNCHES}
    if launches != want:
        raise SystemExit(f"serving path launched {launches}, expected {want}")
    if variants["lru_scan_tma"] != SERVE_LAUNCHES["lru_scan"]:
        raise SystemExit(f"serving path: not every scan ran the TMA kernel "
                         f"({lru_ops.VARIANTS})")
    if tuple(out["tokens"].shape) != (SERVE_BATCH, SERVE_GEN) or \
            not bool(torch.isfinite(out["logits"]).all()):
        raise SystemExit("serving path: wrong token shape or non-finite "
                         "logits")
    return launches


# ---------------------------------------------------------------------------
# phase 8b: the dense and MoE families and continuous batching
# ---------------------------------------------------------------------------

def _flash_case_inputs(case, gen, dev):
    arch, B, S, kind = case
    cfg = get_config(arch)
    H, hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    kw = dict(causal=cfg.causal,
              window=cfg.window_size if kind == "local" else 0,
              softcap=cfg.attn_softcap, scale=1.0 / math.sqrt(D))
    q = torch.randn(B, S, H, D, generator=gen, device=dev)
    k, v = (torch.randn(B, S, hkv, D, generator=gen, device=dev)
            for _ in range(2))
    return (q, k, v), kw


def flash_families_phase(dev) -> None:
    """The attention at the families' prefill shapes (``FLASH_CASES``): in
    bf16 on ``flash_fwd_tc`` within 2e-2 and ``BF16_ULPS`` bf16 ulps of the
    plain version, a limit both fault versions must break at each shape;
    granite-8b's ragged prompt of 517 also in f32 (``flash_fwd``, 2e-5).
    Median CUDA-event times beside the plain version and SDPA with the band
    as a boolean mask, and the bound (as phase 6 prices it)."""
    for i, case in enumerate(FLASH_CASES):
        gen = torch.Generator(device=dev).manual_seed(40 + i)
        ins, kw = _flash_case_inputs(case, gen, dev)
        if case == FLASH_CASES[0] or ins[0].shape[-1] == 80:
            got = flash_ops.flash_attention(*ins, **kw)
            want = flash_attention_ref(*ins, **kw)
            f32_err = float((got - want).abs().max())
            log(f"flash_attention f32 {case}: max abs err {f32_err:.3e} "
                f"(limit {FLASH_TOL[torch.float32]})")
            if not f32_err <= FLASH_TOL[torch.float32]:
                raise SystemExit(f"flash_attention f32 differs from the "
                                 f"plain version at {case}")
            del got, want
        q, k, v = (t.to(torch.bfloat16) for t in ins)
        del ins
        got = flash_ops.flash_attention(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ulps = bf16_ulps(got, want)
        faults = {f: bf16_ulps(flash_attention_fault(q, k, v, f, **kw), want)
                  for f in ("p0", "tile")}
        if not (err <= FLASH_TOL[torch.bfloat16] and ulps <= BF16_ULPS):
            raise SystemExit(f"flash_attention bf16 differs from the plain "
                             f"version at {case}: {err}, {ulps} ulps")
        if not min(faults.values()) > BF16_ULPS:
            raise SystemExit(f"the bf16 ulp check passes a faulty plain "
                             f"version at {case}: {faults}")
        B, S = case[1], case[2]
        mask = band_mask(S, causal=kw["causal"], window=kw["window"],
                         device=dev)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=kw["scale"],
                enable_gqa=True)

        # SDPA takes no soft cap: its time is the library column where the
        # case has none, and is logged beside an uncapped reference
        lib_out = library().transpose(1, 2)
        lib_want = flash_attention_ref(q, k, v, **{**kw, "softcap": 0.0}) \
            if kw["softcap"] else want
        lib_err = float((lib_out.float() - lib_want.float()).abs().max())
        del lib_out, lib_want, got, want
        if not lib_err <= FLASH_TOL[torch.bfloat16]:
            raise SystemExit(f"the library call differs from the plain "
                             f"version at {case} ({lib_err})")
        torch.cuda.empty_cache()
        H, D = q.shape[2], q.shape[3]
        work = flash_ops.work(B, q.shape[1], H, k.shape[2], D, q.dtype,
                              causal=kw["causal"], window=kw["window"])
        moved = work.bytes
        half = work.flops // 4
        ops_ms = work.flops / BF16_TC_FLOPS_PER_S * 1e3
        bound = max(moved / HBM_BYTES_PER_S * 1e3, ops_ms)
        k_ms = timed_ms(lambda: flash_ops.flash_attention(q, k, v, **kw),
                        KERNEL_RUNS)
        p_ms = timed_ms(lambda: flash_attention_ref(q, k, v, **kw), 3)
        l_ms = timed_ms(library, KERNEL_RUNS)
        log(f"flash_attention bf16 {case[0]} q {list(q.shape)} kv "
            f"{list(k.shape)} {kw}: max abs err {err:.3e}, {ulps:.4g} bf16 "
            f"ulps (faults: p0 only {faults['p0']:.4g}, a key tile skipped "
            f"{faults['tile']:.4g}); kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, library (SDPA{', no soft cap' if kw['softcap'] else ''}; "
            f"max abs err {lib_err:.3e}) {l_ms:.4f} ms; bound {bound:.4f} "
            f"ms ({bound / k_ms:.1%} of it; "
            f"{4 * half / k_ms / 1e9:.2f} TFLOP/s of tensor-core work)")
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()


def run_engine(model, params, prompts, budgets, slots: int, cache_len: int):
    """The requests through a ``ServeEngine`` of ``slots`` slots, all
    submitted at once.  Returns each request's tokens and the logits each
    came from (its prefill's, then its decode steps'), the time to each
    first token and each decode step's time (host clock around
    synchronised work; wrappers around the engine's prefill and step)."""
    engine = ServeEngine(model, params, max_slots=slots, cache_len=cache_len)
    logits, first_ms, step_ms = {}, {}, []
    prefill, step = engine._prefill, engine._step

    def timed_prefill(batch):
        out = prefill(batch)
        torch.cuda.synchronize()
        rid = len(first_ms)              # requests are admitted in order
        first_ms[rid] = (time.perf_counter() - t0) * 1e3
        logits[rid] = [out[0][0]]
        return out

    def timed_step(tok, pos):
        active = {slot: req.rid for slot, req in engine.active.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(tok, pos)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        for slot, rid in active.items():
            logits[rid].append(out[0][slot])
        return out

    engine._prefill, engine._step = timed_prefill, timed_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [engine.submit(p, n) for p, n in zip(prompts, budgets)]
    results = engine.run_to_completion()
    # the wrappers close over the engine: drop them, so that the engine,
    # its cache pool and its reference to the parameters are freed with it
    del engine._prefill, engine._step
    if sorted(results) != rids or any(len(results[r]) != n for r, n in
                                      zip(rids, budgets)):
        raise SystemExit(f"the engine did not serve every request its "
                         f"budget: {[len(results.get(r, [])) for r in rids]}")
    return results, logits, first_ms, step_ms


def hold_to_isolated(name: str, model, params, prompts, budgets,
                     cache_len: int, results, logits, tol: float,
                     card_cpu: float = 0.0, rows: int = 1) -> None:
    """Each request's engine tokens against its isolated greedy decode on
    the card (``testing.isolated_greedy``: decoded at batch ``rows``).  At
    every step the engine's logits must be within ``tol`` of the largest
    isolated logit (the same inputs, maybe another batch size); where
    the isolated top-2 margin is no more than twice their difference (or
    ``card_cpu`` of the largest logit, the arch's card/CPU difference), the
    choice could go either way: it is logged and that request is compared
    no further.  Elsewhere (bit-identical logits included, whose ties
    ``argmax`` breaks alike) the tokens must be equal."""
    compared, stopped, worst, same = 0, [], 0.0, 0
    for rid, (p, n) in enumerate(zip(prompts, budgets)):
        iso_tok, iso_lg = isolated_greedy(model, params, p, n, cache_len,
                                          rows)
        for j in range(n):
            a, b = logits[rid][j].float(), iso_lg[j].float()
            scale = float(b.abs().max())
            d = float((a - b).abs().max())
            if not (math.isfinite(d) and bool(torch.isfinite(a).all())):
                raise SystemExit(f"{name}: non-finite logits, request {rid} "
                                 f"step {j}")
            worst = max(worst, d / scale)
            same += same_bits(logits[rid][j], iso_lg[j])
            if not d <= tol * scale:
                raise SystemExit(f"{name}: request {rid} step {j}: the "
                                 f"engine's logits are {d / scale:.3e} of "
                                 f"the largest from the isolated decode's "
                                 f"(limit {tol})")
            margin = top2_margin(b)
            near = max(2 * d, card_cpu * scale)
            # bit-identical logits pick the same token even at a tie
            if near > 0 and margin <= near:
                log(f"{name}: request {rid} step {j}: top-2 margin "
                    f"{margin:.4g} <= max(2 x difference {d:.4g}, card/CPU "
                    f"{card_cpu * scale:.4g}): compared no further")
                stopped.append((rid, j))
                break
            if results[rid][j] != iso_tok[j]:
                raise SystemExit(f"{name}: request {rid} step {j}: engine "
                                 f"token {results[rid][j]} != isolated "
                                 f"{iso_tok[j]} (margin {margin:.4g}, "
                                 f"difference {d:.4g})")
            compared += 1
    total = sum(budgets)
    log(f"{name}: {compared} of {total} tokens equal to the isolated greedy "
        f"decode at batch {rows} (the rest after a near tie: {stopped}); "
        f"engine vs isolated logits at most {worst:.3e} of the largest "
        f"(limit {tol}), bit for bit at {same} of the steps compared")


def reduced_engine_check(dev, arch: str, card_cpu: float) -> None:
    """A reduced arch (f32, params as ``serve_cross_check``'s) through a
    2-slot engine on the card: 5 requests of 8, 11, ..., 20 tokens,
    budgets 6, 4, 8, 5, 7 (slot reuse), held to the isolated decode."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, dtype=torch.float32)
    params = tree_map(lambda t: t.to(dev),
                      model.init(torch.Generator().manual_seed(0)))
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab_size, (8 + 3 * i,),
                             generator=gen).to(dev) for i in range(5)]
    budgets = [6, 4, 8, 5, 7]
    reset_counts()
    results, logits, _, _ = run_engine(model, params, prompts, budgets, 2, 64)
    launches = launch_counts()
    want = {**dict.fromkeys(launches, 0),
            **{k: 5 * v for k, v in _kernel_layers(cfg).items()}}
    if launches != want:
        raise SystemExit(f"reduced engine ({arch}) launched {launches}, "
                         f"expected {want}")
    hold_to_isolated(f"reduced engine {arch} (f32, 5 requests, 2 slots)",
                     model, params, prompts, budgets, 64, results, logits,
                     ENGINE_TOL[torch.float32], card_cpu)


def engine_path(dev, arch: str) -> dict:
    """Full width, bf16, seeded on the card: ``ENGINE_PROMPTS`` with
    ``ENGINE_BUDGETS`` through ``ENGINE_SLOTS`` slots; launches over the
    engine's run alone (the attention once per attention layer of each
    prefill), finite logits, each request held to its isolated decode;
    logs the time to each first token, the decode steps and peak memory."""
    cfg = get_config(arch)
    model = build_model(cfg, dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, cfg.vocab_size, (S,), generator=gen).to(dev)
               for S in ENGINE_PROMPTS]
    cache_len = max(ENGINE_PROMPTS) + max(ENGINE_BUDGETS)
    init_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    results, logits, first_ms, step_ms = run_engine(
        model, params, prompts, ENGINE_BUDGETS, ENGINE_SLOTS, cache_len)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    want = {**dict.fromkeys(launches, 0),
            **{k: len(prompts) * v for k, v in _kernel_layers(cfg).items()}}
    tokens = sum(ENGINE_BUDGETS)
    log(f"engine path: full-width {arch} ({n_params} parameters, bf16), "
        f"{len(prompts)} requests (prompts {list(ENGINE_PROMPTS)}, budgets "
        f"{list(ENGINE_BUDGETS)}) through {ENGINE_SLOTS} slots, cache "
        f"{cache_len}: {tokens} tokens in {wall:.3f} s "
        f"({tokens / wall:.1f} tok/s); time to first token "
        f"{[round(first_ms[r], 3) for r in sorted(first_ms)]} ms; "
        f"{len(step_ms)} decode steps, median "
        f"{statistics.median(step_ms):.3f} ms (min {min(step_ms):.3f}, max "
        f"{max(step_ms):.3f}); peak memory {peak} B (the init's "
        f"{init_peak} B: the layers stacked); launches {launches}")
    if launches != want:
        raise SystemExit(f"engine path ({arch}) launched {launches}, "
                         f"expected {want}")
    # alone at batch 1, and alone at the pool's batch (every operator at
    # the engine step's shapes: another batch size may take other matmul
    # kernels, whose bf16 results differ in the last bits)
    for rows in (1, ENGINE_SLOTS):
        hold_to_isolated(f"engine path {arch} (bf16)", model, params,
                         prompts, ENGINE_BUDGETS, cache_len, results, logits,
                         ENGINE_TOL[torch.bfloat16], rows=rows)
    del params, logits
    torch.cuda.empty_cache()
    return launches


def batched_path(dev, arch: str) -> dict:
    """Full width through ``launch/serve.py`` (bf16, ``BATCHED``'s batch,
    prompt and tokens): launches over that run alone (the attention once
    per attention layer), finite logits, prefill and decode times and
    peak memory."""
    B, S, G = BATCHED[arch]
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    out = serve.main(["--arch", arch, "--batch", str(B), "--prompt-len",
                      str(S), "--gen", str(G), "--seed", "0"])
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    moe = ""
    if cfg.num_experts:
        T = B * S
        path = ("capacity dispatch, C = "
                f"{int(T * cfg.experts_per_token // cfg.num_experts * 1.25)}"
                if T > MOE_DENSE_TOKEN_LIMIT else "dense combine")
        moe = f"; the prefill's MoE layers: T = {T}, {path}; decode: T = {B}"
    log(f"batched path: full-width {arch} ({cfg.num_layers} layers), bf16, "
        f"batch {B}, prompt {S}, "
        f"{G} tokens: prefill {out['prefill_ms']:.3f} ms, decode "
        f"{out['decode_ms_per_step']:.3f} ms per step ({B} tokens), peak "
        f"memory {peak} B, launches {launches}{moe}")
    want = {**dict.fromkeys(launches, 0), **_kernel_layers(cfg)}
    if launches != want:
        raise SystemExit(f"batched path ({arch}) launched {launches}, "
                         f"expected {want}")
    if tuple(out["tokens"].shape) != (B, G) or \
            not bool(torch.isfinite(out["logits"]).all()):
        raise SystemExit(f"batched path ({arch}): wrong token shape or "
                         f"non-finite logits")
    del out
    torch.cuda.empty_cache()
    return launches


def families_phase(dev, rg_card_cpu: float) -> dict:
    """Phase 8b; returns the launches of its full-width paths."""
    t0 = time.perf_counter()
    flash_families_phase(dev)
    t1 = time.perf_counter()
    card_cpu = {arch: serve_cross_check(dev, arch) for arch in FAMILY_ARCHS}
    card_cpu[SERVE_ARCH] = rg_card_cpu
    for arch in ENGINE_ARCHS:
        reduced_engine_check(dev, arch, card_cpu[arch])
    t2 = time.perf_counter()
    total = {}
    for arch, path in FULL_WIDTH_SERVING:
        t = time.perf_counter()
        launches = path(dev, arch)
        log(f"{path.__name__} {arch} took {time.perf_counter() - t:.1f} s")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    log(f"phase 8b (the families and continuous batching) took "
        f"{time.perf_counter() - t0:.1f} s: flash shapes {t1 - t0:.1f} s, "
        f"reduced checks {t2 - t1:.1f} s, full width "
        f"{time.perf_counter() - t2:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 8c: the audio and VLM front ends and every family's training
# ---------------------------------------------------------------------------

def _flat_bytes(groups, m: int) -> tuple:
    """(the flat state's bytes, the least a FedBiOAcc step holds at once)
    over ``m`` clients: per element the variable in its buffer's dtype and
    the f32 momentum; while ``storm3_step`` runs also their successors and
    the f32 old-iterate direction."""
    state = m * sum(g.padded * (g.dtype.itemsize + 4) for g in groups)
    least = m * sum(g.padded * (2 * g.dtype.itemsize + 12) for g in groups)
    return state, least


def _family_steps(run, exp: Experiment, dev) -> tuple:
    """The run's steps from a seeded state on the card: each step's time
    between two CUDA events, the peak memory over the steps, the launches
    over them alone, and client 0's validation loss before and after."""
    state = run.init(torch.Generator(device=dev).manual_seed(
        exp.schedule.seed))
    data = torch.Generator().manual_seed(exp.schedule.seed)
    batches = [run.batch_fn(data) for _ in range(exp.schedule.steps)]
    val0 = run.eval_fn(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    step_ms = []
    for batch in batches:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, _ = run.step(state, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    val1 = run.eval_fn(state)
    return step_ms, peak, launches, val0, val1


def family_train_path(arch: str, depths: tuple, base: Experiment,
                      dev) -> tuple:
    """FedBiOAcc on ``arch`` at full width (``full_width_experiment``,
    ``FAMILY_STEPS`` steps) at the first of ``depths`` whose flat buffers
    fit the card (reckoned from the layout first, ``_flat_bytes``) and
    whose steps do not run out of memory; logs each depth skipped with the
    bytes that stopped it.  Returns the launches of the run and its
    buffers (``{}`` and None when no depth fits)."""
    exp = full_width_experiment(base.edit(**{"problem.arch": arch})).edit(
        **{"schedule.steps": FAMILY_STEPS})
    m = exp.problem.num_clients
    cap = torch.cuda.get_device_properties(dev).total_memory
    full = get_config(arch).num_layers
    for layers in depths:
        with _depth(layers or full):
            run = build(exp, device=dev)
        groups = run.init.spec.groups
        state_b, least_b = _flat_bytes(groups, m)
        sizes = [f"{str(g.dtype).replace('torch.', '')}[{m}, {g.padded}]"
                 for g in groups]
        what = (f"{arch} ({run.model_cfg.family}) at {layers or full} of "
                f"{full} layers, buffers {sizes}")
        if least_b > cap:
            log(f"train {what}: flat state {state_b} B, at least {least_b} "
                f"B held during a step, more than the card's {cap} B: not "
                f"run")
            continue
        oom = None
        try:
            step_ms, peak, launches, val0, val1 = _family_steps(run, exp,
                                                                dev)
        except torch.cuda.OutOfMemoryError as err:
            oom = str(err).split("\n")[0]
        del run
        # the failed run's frames hold its state in reference cycles
        gc.collect()
        torch.cuda.empty_cache()
        if oom is not None:
            log(f"train {what}: flat state {state_b} B (at least {least_b} "
                f"B during a step): out of memory in the run ({oom})")
            continue
        want = {**dict.fromkeys(launches, 0),
                "storm3_step": FAMILY_STEPS * len(groups)}
        log(f"train {what}: FedBiOAcc, {m} clients, 1 x 512 tokens each, "
            f"flat state {state_b} B (at least {least_b} B during a step), "
            f"step ms {[round(t, 3) for t in step_ms]}, peak memory {peak} "
            f"B, launches {launches} (storm3_step once per buffer a step), "
            f"val_loss {val0} before, {val1} after")
        if launches != want:
            raise SystemExit(f"train {arch} launched {launches}, expected "
                             f"{want}")
        if not (math.isfinite(val0) and math.isfinite(val1)):
            raise SystemExit(f"train {arch}: non-finite validation loss")
        return launches, groups
    if arch in REQUIRED_TRAIN:
        raise SystemExit(f"train {arch}: no depth of {depths} fits the card")
    log(f"train {arch}: no depth of {depths} fits the card at full width "
        f"with {m} clients (the bytes above)")
    return {}, None


def storm_family_check(arch: str, groups, m: int, dev) -> None:
    """A phase-3 entry at the largest buffers a family trained on:
    ``storm3_step`` (as ``KERNELS`` feeds it: the variable in the buffer's
    dtype, f32 momentum and direction, per-tile tables) bit for bit against
    its plain version, taken ``CHECK_TILES`` tiles at a time (it is
    elementwise over tiles, so a slice has the whole call's bits), timed
    beside its bound."""
    k = KERNELS["storm3_step"]
    gen = torch.Generator(device=dev).manual_seed(9)
    for grp in groups:
        n = m * grp.padded
        tiles = n // grp.block
        args = k.inputs(n, tiles, grp, gen, dev)
        out = k.wrapper(*args, block=grp.block)
        ok = True
        for t0 in range(0, tiles, CHECK_TILES):
            t1 = min(tiles, t0 + CHECK_TILES)
            a, b = t0 * grp.block, t1 * grp.block
            want = k.plain(*(x[a:b] for x in args[:3]),
                           *(x[t0:t1] for x in args[3:]), grp.block)
            ok = ok and all(same_bits(o[a:b], w) for o, w in zip(out, want))
        torch.cuda.synchronize()
        work = kernel_work("storm3_step", n, grp)
        moved = work.bytes
        del out
        if not ok:
            raise SystemExit(f"storm3_step differs from the plain version at "
                             f"{arch}'s {grp.dtype} buffer")
        torch.cuda.empty_cache()
        k_ms = timed_ms(lambda: k.wrapper(*args, block=grp.block), 10)
        bound = max(moved / HBM_BYTES_PER_S,
                    work.flops / F32_FLOPS_PER_S) * 1e3
        log(f"storm3_step {str(grp.dtype).replace('torch.', '')} group "
            f"[{m}, {grp.padded}] ({arch}'s training buffer): bitwise equal "
            f"to the plain version, kernel {k_ms:.4f} ms, {moved} B, bound "
            f"{bound:.4f} ms ({moved / k_ms / 1e6:.1f} GB/s, "
            f"{bound / k_ms:.1%} of the bound)")
        del args
        torch.cuda.empty_cache()


def encode_path(dev) -> dict:
    """hubert-xlarge's encoder at full width, all 48 layers, bf16 seeded on
    the card: ``Model.forward`` with ``use_flash`` over ``ENCODE_BATCH``
    clips of ``ENCODE_FRAMES`` frames, twice (the launches and peak of the
    second alone); finite logits of the expected shape, the attention once
    a layer (D 80, not causal), and the logits beside the same forward with
    the plain attention."""
    arch = "hubert-xlarge"
    cfg = get_config(arch)
    model = build_model(cfg, dtype=torch.bfloat16)
    frames = torch.randn((ENCODE_BATCH, ENCODE_FRAMES, cfg.frontend_dim),
                         generator=torch.Generator().manual_seed(0))
    batch = {"frames": frames.to(torch.bfloat16).to(dev)}
    with torch.no_grad():
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            t0 = time.perf_counter()
            logits, _ = model.forward(params, batch, use_flash=True)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        plain, _ = model.forward(params, batch)
    diff = float((logits - plain).abs().max() / plain.abs().max())
    want = {**dict.fromkeys(launches, 0), **_kernel_layers(cfg)}
    log(f"encode path: full-width {arch} ({cfg.num_layers} layers, bf16), "
        f"{ENCODE_BATCH} x {ENCODE_FRAMES} frames: forward {ms[0]:.3f} ms "
        f"cold, {ms[1]:.3f} ms warm (host clock to a synchronise), peak "
        f"memory {peak} B, launches {launches}; logits "
        f"{list(logits.shape)}, against the plain attention's "
        f"{diff:.3e} of the largest (bf16 through {cfg.num_layers} layers)")
    if launches != want:
        raise SystemExit(f"encode path launched {launches}, expected {want}")
    if tuple(logits.shape) != (ENCODE_BATCH, ENCODE_FRAMES, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise SystemExit("encode path: wrong logit shape or non-finite "
                         "logits")
    del params, logits, plain
    torch.cuda.empty_cache()
    return launches


def frontends_phase(dev) -> dict:
    """Phase 8c; returns the launches of its full-width paths."""
    t0 = time.perf_counter()
    for arch in ("internvl2-76b", "hubert-xlarge"):
        serve_cross_check(dev, arch)
    base = Experiment.load(os.path.join(ROOT, "experiments",
                                        "fedbioacc.json"))
    for arch, _ in TRAIN_DEPTHS:
        cross_check(f"fedbioacc ({arch})",
                    base.edit(**{"problem.arch": arch}), dev)
    t1 = time.perf_counter()
    total, largest = {}, None
    for arch, depths in TRAIN_DEPTHS:
        t = time.perf_counter()
        launches, groups = family_train_path(arch, depths, base, dev)
        log(f"train {arch} took {time.perf_counter() - t:.1f} s")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if groups is not None and (largest is None or sum(
                g.padded for g in groups) > sum(g.padded
                                                for g in largest[1])):
            largest = (arch, groups)
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    storm_family_check(*largest, CLIENTS, dev)
    t3 = time.perf_counter()
    with _depth(VLM_LAYERS):
        served = batched_path(dev, "internvl2-76b")
    for launches in (served, encode_path(dev)):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    log(f"phase 8c (the front ends and every family's training) took "
        f"{time.perf_counter() - t0:.1f} s: reduced checks {t1 - t0:.1f} s, "
        f"full-width training {t2 - t1:.1f} s, storm3_step at "
        f"{largest[0]}'s buffers {t3 - t2:.1f} s, VLM serving and the "
        f"encoder {time.perf_counter() - t3:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 9: the paper's problems, Algorithms 1-4 and the Table-1 baselines
# ---------------------------------------------------------------------------

PAPER_CORE = ("fedbio", "fedbioacc", "fedbio_local", "fedbioacc_local")
PAPER_BASELINES = ("fednest", "commfedbio", "stocbio", "mrbo")
PAPER_KERNEL = {"fedbio": "sgd3_step", "fedbio_local": "sgd3_step",
                "fedbioacc": "storm3_step", "fedbioacc_local": "storm3_step"}
PAPER_BLOCKS = (64, 1024)
# the examples' runs of the JAX package on a CPU (jax 0.9.0, 200 rounds):
# detection AUC, and the upper validation loss before and after
PAPER_REFERENCE = {"fedbioacc": 0.8457, "fedbioacc_local": (1.4803, 1.1935),
                   "fedbio_local": (1.3161, 0.8870)}
# MNIST's shape (60,000 samples of 28x28 features, 10 classes), synthetic
REAL_ROUNDS = 20
REAL = {"data_cleaning": dict(num_clients=10, n_train=60_000, n_val=1_000,
                              dim=784, classes=10, corrupt_frac=0.4,
                              batch_size=256),
        "hyperrep": dict(num_clients=10, n=6_000, dim=784, hidden=256,
                         classes=10, batch_size=256)}
REAL_ALGOS = {"data_cleaning": ("fedbioacc", "fedbio"),
              "hyperrep": ("fedbioacc_local", "fedbio_local")}
# the examples' step sizes (examples/data_cleaning.py, hyper_representation.py)
EXAMPLE_LRS = {"data_cleaning": dict(lr_x=0.3, lr_y=0.3, lr_u=0.3),
               "hyperrep": dict(lr_x=0.1, lr_y=0.2, lr_u=0.2, neumann_q=10,
                                neumann_tau=0.15)}


def _paper_problems():
    """The three problems at the reference's default sizes, built once on
    the CPU: name → (CPU problem, the same arrays' problem on ``dev``)."""
    quad = problems.quadratic_problem(jr.PRNGKey(0))
    arrays = {k: v for k, v in quad.sample_batches(jr.PRNGKey(0)).items()
              if k in ("Ag", "B", "c", "D", "x0", "y0")}
    clean = problems.data_cleaning_problem(jr.PRNGKey(1))
    hyper = problems.hyperrep_problem(jr.PRNGKey(2))
    return {
        "quadratic": (problems.quadratic_from_arrays(arrays),
                      lambda d: problems.quadratic_from_arrays(
                          tree_map(lambda t: t.to(d), arrays))),
        "data_cleaning": (clean, lambda d: problems.data_cleaning_from_data(
            tree_map(lambda t: t.to(d), clean.data))),
        "hyperrep": (hyper, lambda d: problems.hyperrep_from_data(
            tree_map(lambda t: t.to(d), hyper.data)))}


def _state_leaves(state):
    return [t for name in state._fields[:-1]
            for t in tree_leaves(getattr(state, name))]


def _two_rounds(prob, cfg, dev):
    alg = make_algorithm(prob, cfg)
    state = alg.init(jr.PRNGKey(1, device=dev))
    key = jr.PRNGKey(2, device=dev)
    for _ in range(2):
        key, sub = jr.split(key)
        state, _ = alg.round(state, sub)
    return state


def _topk_following(orig, calls: list, flips: list):
    """CommFedBiO's compressor on the card taking the CPU run's keep
    decisions (``calls``: its recorded inputs and outputs), after checking
    that every entry decided otherwise lies within 2·D of the CPU's
    threshold, D the largest difference of the two inputs in the leaf (the
    threshold is an order statistic: it moves by at most D;
    ``testing.leaf_topk_flips``); ``orig`` is the compressor itself."""
    def follow(tree, ratio):
        c_in, c_out = calls.pop(0)
        out = []
        for a, kept, b in zip(tree_leaves(c_in), tree_leaves(c_out),
                              tree_leaves(tree)):
            try:
                off = leaf_topk_flips(a.numpy(), kept.numpy() != 0,
                                      b.cpu().numpy(),
                                      orig(b, ratio).cpu().numpy() != 0,
                                      ratio)
            except AssertionError as err:
                raise SystemExit(f"commfedbio: the card's top-k decided "
                                 f"entries far from the threshold "
                                 f"otherwise {err}") from err
            flips.append(int(off.sum()))
            out.append(torch.where(kept.to(b.device) != 0, b, 0.0))
        return tree_structure(tree).unflatten(out)
    return follow


def random_cross_check(dev) -> None:
    """The Threefry generator draws on the key's device: on the card the
    keys, bits, integers and uniforms equal the CPU's bit for bit, and the
    normals agree within 4 f32 ulps (``log1p`` and ``sqrt`` differ)."""
    key = jr.PRNGKey(7)
    draws = (lambda k: jr.split(k, 5), lambda k: jr.fold_in(k, 3),
             lambda k: jr.bits(k, (1000,)),
             lambda k: jr.randint(k, (8, 256), 0, 60_000),
             lambda k: jr.uniform(k, (1000,), minval=0.3, maxval=1.7),
             lambda k: jr.permutation(k, 2000))
    for i, draw in enumerate(draws):
        if not same_bits(draw(key.to(dev)).cpu(), draw(key)):
            raise SystemExit(f"the generator's draw {i} differs on the card")
    got, want = jr.normal(key.to(dev), (100_000,)).cpu(), jr.normal(key,
                                                                 (100_000,))
    ulp = (got.double() - want.double()).abs() / torch.from_numpy(np.spacing(
        np.maximum(got.abs().numpy(), want.abs().numpy())).astype(np.float64))
    differ = float((ulp > 0).double().mean())
    log(f"generator on the card: keys, bits, randint, uniform and "
        f"permutation bit for bit with the CPU's; normals within "
        f"{float(ulp.max()):.0f} ulps (limit 4; {differ:.4%} differ)")
    if not float(ulp.max()) <= 4:
        raise SystemExit("the generator's normals differ on the card")


def paper_cross_check(dev) -> None:
    """(a) Two rounds of each algorithm on the card against two on the CPU
    from the same keys and the same problem arrays, within 1e-4 of each
    state leaf's norm; Algorithms 1-4 with fuse_storm off and on (tiles of
    64 and of 1024), each fused run within rtol 1e-5 / atol 1e-5 of the
    card's tree loop, with its kernel launched once a local step."""
    worst, fused_worst, flips = 0.0, 0.0, []
    for pname, (cpu_prob, on) in _paper_problems().items():
        card_prob = on(dev)
        for algo in PAPER_CORE + PAPER_BASELINES:
            variants = [(False, 1024)]
            if algo in PAPER_CORE:
                variants += [(True, b) for b in PAPER_BLOCKS]
            tree_card = None
            for fuse, block in variants:
                cfg = FederatedConfig(algorithm=algo, num_clients=8,
                                      fuse_storm=fuse, fuse_storm_block=block)
                orig, calls = baselines._topk_compress, []

                def record(tree, ratio):
                    out = orig(tree, ratio)
                    calls.append((tree, out))
                    return out

                baselines._topk_compress = record
                try:
                    cpu = _two_rounds(cpu_prob, cfg, torch.device("cpu"))
                    baselines._topk_compress = _topk_following(orig, calls,
                                                               flips)
                    reset_counts()
                    card = _two_rounds(card_prob, cfg, dev)
                finally:
                    baselines._topk_compress = orig
                torch.cuda.synchronize()
                launches = launch_counts()
                want = dict.fromkeys(launches, 0)
                if fuse:
                    want[PAPER_KERNEL[algo]] = 2 * cfg.local_steps
                if launches != want:
                    raise SystemExit(f"{pname} {algo} fuse_storm={fuse}: "
                                     f"launched {launches}, expected {want}")
                for g, c in zip(_state_leaves(card), _state_leaves(cpu)):
                    diff = float((g.cpu() - c).norm())
                    if not diff <= 1e-4 * float(c.norm()):
                        raise SystemExit(
                            f"{pname} {algo} fuse_storm={fuse} block "
                            f"{block}: card vs CPU {diff} of norm "
                            f"{float(c.norm())}")
                    worst = max(worst, diff / max(float(c.norm()), 1e-30))
                if not fuse:
                    tree_card = card
                    continue
                for g, t in zip(_state_leaves(card), _state_leaves(tree_card)):
                    if not torch.allclose(g, t, rtol=1e-5, atol=1e-5):
                        raise SystemExit(f"{pname} {algo} block {block}: the "
                                         f"fused run differs from the tree "
                                         f"loop on the card")
                    fused_worst = max(fused_worst, float(
                        ((g - t).abs() / (1e-5 + 1e-5 * t.abs())).max()))
    log(f"paper cross-check (quadratic M 8 dx = dy = 10, data cleaning "
        f"n_train 256, hyper-representation defaults; 8 algorithms, 2 "
        f"rounds, Algorithms 1-4 also fused at tiles of {PAPER_BLOCKS}): "
        f"card vs CPU worst relative leaf difference {worst:.3e} (limit "
        f"1e-4); fused vs tree loop on the card worst {fused_worst:.3f} of "
        f"rtol 1e-5 / atol 1e-5; CommFedBiO top-k decisions taken "
        f"otherwise on the card {sum(flips)} of {len(flips)} leaf calls, "
        f"each within 2·D of the threshold")


def _counted(name: str, kernel: str, steps: int, fn):
    """``fn()`` with the launches counted over it alone: ``kernel`` once a
    local step, every other kernel never.  Returns (fn's result, counts)."""
    torch.cuda.synchronize()
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = launch_counts()
    want = {**dict.fromkeys(launches, 0), kernel: steps}
    if launches != want:
        raise SystemExit(f"{name} launched {launches}, expected {want}")
    return out, launches


def paper_examples(dev) -> dict:
    """(b) The examples on the card with their own settings, fuse_storm on,
    200 rounds: FedBiOAcc's data-cleaning AUC above 0.75, the two
    local-lower algorithms' upper loss falling; beside the reference's
    CPU results.  Returns the launches."""
    total = {}
    t0 = time.perf_counter()
    (_, auc), n = _counted(
        "data_cleaning fedbioacc", "storm3_step", 800,
        lambda: cleaning_ex.run("fedbioacc", 200, dev, fuse_storm=True,
                                     report_every=200, log=log))
    log(f"example data_cleaning fedbioacc (fused, 200 rounds, "
        f"{time.perf_counter() - t0:.1f} s): detection AUC {auc:.4f} "
        f"(reference {PAPER_REFERENCE['fedbioacc']}; limit > 0.75)")
    if not auc > 0.75:
        raise SystemExit("data cleaning on the card failed to separate the "
                         "corrupted samples")
    total = {k: total.get(k, 0) + v for k, v in n.items()}
    for algo in ("fedbioacc_local", "fedbio_local"):
        t0 = time.perf_counter()
        (v0, vT), n = _counted(
            f"hyperrep {algo}", PAPER_KERNEL[algo], 800,
            lambda a=algo: hyperrep_ex.run(a, 200, dev, fuse_storm=True,
                                           log=log))
        ref = PAPER_REFERENCE[algo]
        log(f"example hyperrep {algo} (fused, 200 rounds, "
            f"{time.perf_counter() - t0:.1f} s): upper loss {v0:.4f} -> "
            f"{vT:.4f} (reference {ref[0]} -> {ref[1]})")
        if not (math.isfinite(vT) and vT < v0):
            raise SystemExit(f"hyperrep {algo}: the upper loss did not fall")
        total = {k: total.get(k, 0) + v for k, v in n.items()}
    return total


def _real_problem(pname: str, dev):
    if pname == "data_cleaning":
        return problems.data_cleaning_problem(jr.PRNGKey(1, device=dev),
                                              **REAL[pname])
    return problems.hyperrep_problem(jr.PRNGKey(2, device=dev),
                                     **REAL[pname])


def paper_realistic(dev) -> tuple:
    """(c) Each problem at MNIST's shape, 10 clients, 4 local steps, the
    examples' step sizes, fuse_storm on, 20 rounds: warm round times (host
    clock around synchronised work), peak memory, launches, a finite upper
    objective; then ``storm3_step`` and ``sgd3_step`` on the paths' own
    buffers, bit for bit and timed.  Returns (launches, buffers)."""
    total, buffers = {}, {}
    for pname, algos in REAL_ALGOS.items():
        prob = _real_problem(pname, dev)
        batch = tree_map(lambda v: v[0], prob.sample_batches(jr.PRNGKey(9)))
        for algo in algos:
            cfg = FederatedConfig(algorithm=algo, num_clients=10,
                                  local_steps=4, fuse_storm=True,
                                  **EXAMPLE_LRS[pname])
            alg = make_algorithm(prob, cfg)
            # the data on the card, the keys on the host (as the examples)
            state = alg.init(jr.PRNGKey(0))
            key = jr.PRNGKey(3)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)

            def rounds():
                nonlocal state, key
                times = []
                for _ in range(REAL_ROUNDS):
                    key, sub = jr.split(key)
                    t0 = time.perf_counter()
                    state, _ = alg.round(state, sub)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                return times

            times, n = _counted(f"{pname} {algo} at MNIST's shape",
                                PAPER_KERNEL[algo], 4 * REAL_ROUNDS, rounds)
            peak = torch.cuda.max_memory_allocated(dev)
            x, y = alg.mean_x(state), mean_over_clients(state.y)
            upper = float(prob.f(x, y, batch))
            extra = ""
            if pname == "data_cleaning":
                auc = cleaning_ex.detection_auc(x, prob.data["corrupt_mask"])
                extra = f", detection AUC {auc:.4f}"
            warm = times[1:]
            log(f"realistic {pname} {algo} ({REAL[pname]}, 4 local steps, "
                f"{REAL_ROUNDS} rounds, {EXAMPLE_LRS[pname]}): round ms "
                f"median {statistics.median(warm):.2f} (first "
                f"{times[0]:.2f}, warm min {min(warm):.2f} max "
                f"{max(warm):.2f}), peak memory {peak} B, launches "
                f"{ {k: v for k, v in n.items() if v} }, upper objective "
                f"{upper:.6f}{extra}")
            if not math.isfinite(upper):
                raise SystemExit(f"{pname} {algo}: non-finite upper "
                                 f"objective")
            total = {k: total.get(k, 0) + v for k, v in n.items()}
            x1, y1 = prob.init_xy(jr.PRNGKey(0))
            aspec = seqs.SPECS[algo]
            tmpl = {"x": x1, "y": y1, "u": y1}
            spec = flat.make_spec({s: tmpl[s] for s in aspec.sections},
                                  sections=aspec.sections,
                                  block=cfg.fuse_storm_block)
            trees = {"x": state.x, "y": state.y,
                     "u": getattr(state, "u", None)}
            moms = {"x": getattr(state, "nu", None),
                    "y": getattr(state, "omega", None),
                    "u": getattr(state, "q", None)}
            bufs = flat.flatten_tree(spec, {s: trees[s]
                                            for s in aspec.sections},
                                     batch_dims=1)
            mom = (flat.flatten_tree(spec, {s: moms[s]
                                            for s in aspec.sections},
                                     batch_dims=1, dtype=torch.float32)
                   if aspec.kind == "storm" else None)
            buffers[f"{pname} {algo}"] = (PAPER_KERNEL[algo], spec, bufs[0],
                                          None if mom is None else mom[0])
            del alg, state
        del prob
        torch.cuda.empty_cache()
    return total, buffers


def paper_kernels(buffers: dict, dev) -> None:
    """``storm3_step`` and ``sgd3_step`` on the realistic paths' own
    buffers (their final variables and momenta; the old-iterate gradient a
    draw of the same shape), bit for bit against the plain versions, timed
    beside them."""
    gen = torch.Generator(device=dev).manual_seed(9)
    for what, (kname, spec, p, m) in buffers.items():
        grp = spec.groups[0]
        tiles = p.numel() // grp.block
        lrs = 0.1 * torch.rand(tiles, generator=gen, device=dev)
        decays = torch.rand(tiles, generator=gen, device=dev)
        p = p.contiguous().reshape(-1)
        g = torch.randn(p.shape, generator=gen, device=dev)
        if kname == "storm3_step":
            m = m.contiguous().reshape(-1)
            args = (p, m, g, lrs, decays)
        else:
            args = (p, g, lrs)
        k = KERNELS[kname]
        out = k.wrapper(*args, block=grp.block)
        want = k.plain(*args, grp.block)
        torch.cuda.synchronize()
        out, want = ((o,) if torch.is_tensor(o) else o for o in (out, want))
        if not all(same_bits(o, w) for o, w in zip(out, want)):
            raise SystemExit(f"{kname} differs from its plain version on "
                             f"the {what} buffers")
        work = kernel_work(kname, p.numel(), grp)
        moved = work.bytes
        k_ms = timed_ms(lambda: k.wrapper(*args, block=grp.block),
                        KERNEL_RUNS)
        p_ms = timed_ms(lambda: k.plain(*args, grp.block), PLAIN_RUNS)
        bound = max(moved / HBM_BYTES_PER_S,
                    work.flops / F32_FLOPS_PER_S) * 1e3
        log(f"{kname} on the {what} path's buffers f32 "
            f"[{p.numel() // grp.padded}, {grp.padded}] (tile {grp.block}): "
            f"bitwise equal, kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"{moved} B, bound {bound:.4f} ms ({bound / k_ms:.1%} of the "
            f"bound)")


def paper_checks() -> float:
    """Phase 9's generator check and (a), which time nothing, in a child
    process of their own (started during phase 4); returns their
    seconds."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    random_cross_check(dev)
    paper_cross_check(dev)
    # both examples at once, each a process of its own on the card
    t1 = time.perf_counter()
    started = {name: _start_session(["-m", f"repro_torch.examples.{name}"],
                                    ONE_THREAD)
               for name in ("quickstart", "fair_federated_learning")}
    for name, proc in started.items():
        out = _run_session(proc.args, 600.0, proc=proc)
        log(f"example {name} on the card (both done "
            f"{time.perf_counter() - t1:.1f} s after their start): exit "
            f"{out.returncode}; " + " | ".join(
                out.stdout.strip().splitlines()[-4:]))
        if out.returncode != 0:
            raise SystemExit(f"example {name} exited {out.returncode}:\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
    return time.perf_counter() - t0


def paper_phase(dev, checks_s: float) -> dict:
    """Phase 9: (b) and (c), after the generator check and (a) (seconds
    ``checks_s``, in phase 4's child); returns the launches of (b) and
    (c)."""
    t1 = time.perf_counter()
    launches = paper_examples(dev)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    real, buffers = paper_realistic(dev)
    paper_kernels(buffers, dev)
    del buffers
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    log(f"phase 9 (the paper's problems) took {t3 - t1:.1f} s here: (b) "
        f"{t2 - t1:.1f} s, (c) {t3 - t2:.1f} s; the generator and (a) "
        f"{checks_s:.1f} s in phase 4's child process")
    return {k: launches.get(k, 0) + real.get(k, 0)
            for k in set(launches) | set(real)}


# phase 8b's full-width runs, in order, each model freed before the next
FULL_WIDTH_SERVING = (("granite-8b", engine_path),
                      ("gemma2-2b", batched_path),
                      ("olmoe-1b-7b", batched_path),
                      ("mamba2-130m", engine_path))


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        raise SystemExit(1)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card_line())

    t0 = time.perf_counter()
    libs = kbuild.build_all()
    log(f"built {sorted(libs)} for sm_90a in {time.perf_counter() - t0:.2f} s")
    for lib in libs.values():
        log_path = lib.with_suffix(".log")
        if log_path.is_file():
            log(log_path.read_text().strip())
    # phase 4c runs here, alone: started beside phase 4's load, the
    # verifier's gloo ranks hung in the CUDA driver in four of eight runs
    # (not one stack to dump; my chip runs, PR 29), and never alone
    analysis_phase()

    bases = {name: Experiment.load(os.path.join(ROOT, "experiments",
                                                f"{name}.json"))
             for name in PATHS if name not in (HIERARCHICAL, STRAGGLED_INT8)}
    bases[HIERARCHICAL] = bases["fedbioacc"].edit(**HIER_EDITS)
    bases[STRAGGLED_INT8] = dataclasses.replace(
        bases[STRAGGLED], compression=bases[COMPRESSED].compression)
    fulls = {name: full_width_experiment(b) for name, b in bases.items()}
    # the straggler path also computes every telemetry group it applies
    # to (health and stragglers at its 8 clients)
    fulls[STRAGGLED] = fulls[STRAGGLED].edit(**{"telemetry.metrics": None})
    runs = {name: build(f, device=dev) for name, f in fulls.items()}
    groups_of = {name: r.init.spec.groups for name, r in runs.items()}
    gates = {path: gate_mask(runs[path], fulls[path].problem.num_clients)
             for _, path in GATED}
    # the weights of the schedule's reductions: round 0's arrivals, and the
    # participants of the round the hierarchical path reduces pod-locally
    weights = {STRAGGLED_INT8: gate_mask(runs[STRAGGLED_INT8], 8)[0],
               HIERARCHICAL: runs[HIERARCHICAL].init.participation.mask_fn(0)}
    del runs
    kernels = kernel_phase(groups_of, dev)
    non_finite_phase(dev)
    compression_phase(groups_of[COMPRESSED], dev)
    torch.cuda.empty_cache()
    reductions_phase(groups_of, weights, dev)
    t3 = time.perf_counter()
    log(f"phases 1-3 took {t3 - t_start:.1f} s")
    gated_phase(groups_of, gates, dev)
    kernels["storm_update"] = storm_update_phase(dev)
    log(f"phase 3b took {time.perf_counter() - t3:.1f} s")

    # the two train CLI checks that run only subprocesses wait on them from
    # threads of their own, and phase 9's checks run in a child process,
    # while this one cross-checks (timing nothing until they are joined); a
    # failure there stops the script at the join
    pool = concurrent.futures.ThreadPoolExecutor(2)
    child = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    clis = [pool.submit(cli_resume_phase), pool.submit(cli_fault_phase)]
    paper = child.submit(paper_checks)
    sharded = start_sharded_phase()
    t = time.perf_counter()
    for name, base in bases.items():
        if name in (HIERARCHICAL, STRAGGLED_INT8):
            round_cross_check(name, base, dev)
            continue
        if name != STRAGGLED:
            cross_check(name, base, dev)
            continue
        for policy in ("drop", "carry", "cancel"):
            cross_check(f"{name} ({policy})", base.edit(
                **{"stragglers.late_policy": policy}), dev,
                steps=2 * base.schedule.local_steps)
    base = bases[FAULTY]
    for what, edits in (("clip", {}), ("trim", {"robustness.aggregator":
                                                "trim"}),
                        ("mean", {"robustness.aggregator": "mean"}),
                        (f"clip, dropout_rate {FAULT_DROPOUT}",
                         {"faults.dropout_rate": FAULT_DROPOUT}),
                        ("robustness null", None)):
        exp = (base.edit(**edits) if edits is not None else
               dataclasses.replace(base, robustness=None))
        fault_cross_check(f"{FAULTY} ({what})", exp, dev)
    log(f"the reduced cross-checks took {time.perf_counter() - t:.1f} s")
    telemetry_cross_check(dev)
    cli_schedule_phase()
    t = time.perf_counter()
    for f in clis:
        f.result()
    pool.shutdown()
    paper_s = paper.result()
    child.shutdown()
    sharded_launches, b_entries = sharded_phase(sharded)
    for kname, k in kernels.items():
        k["launches"] += sharded_launches.get(kname, 0)
    log(f"waited {time.perf_counter() - t:.1f} s for the train CLI's "
        f"subprocess checks and phase 9's child")
    t4 = time.perf_counter()
    log(f"phases 3b-4 took {t4 - t3:.1f} s")
    # phase 4d's traces allocate nothing on the card and time nothing: two
    # children run them beside phases 5-9, whose main process alone is busy
    dry = [concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn")) for _ in range(2)]
    dry_specs, dry_checks = (dry[0].submit(dryrun_specs),
                             dry[1].submit(dryrun_checks))
    for name, full in fulls.items():
        t = time.perf_counter()
        with _depth(MAIN_LAYERS):
            if name == FAULTY:
                launches = faulty_path(name, full, dev)
            elif name == TELEMETRY:
                launches = telemetry_path(name, full, dev)
            else:
                launches = main_path(name, full, dev)
        torch.cuda.empty_cache()
        log(f"path {name} took {time.perf_counter() - t:.1f} s")
        for kname, k in kernels.items():
            k["launches"] += launches[kname]
    log(f"phase 5 took {time.perf_counter() - t4:.1f} s")
    t = time.perf_counter()
    launches, real_b = dryrun_path(dev)
    for kname, k in kernels.items():
        k["launches"] += launches[kname]
    log(f"phase 4d (b)'s real step took {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()
    launches = tree_path_phase(dev)
    for kname, k in kernels.items():
        k["launches"] += launches.get(kname, 0)

    kernels["lru_scan"] = lru_phase(dev)
    kernels["flash_attention"] = flash_phase(dev)
    torch.cuda.empty_cache()
    rg_card_cpu = serve_cross_check(dev, SERVE_ARCH)
    launches = serving_path(dev)
    for kname, k in kernels.items():
        k["launches"] += launches[kname]

    torch.cuda.empty_cache()
    launches = families_phase(dev, rg_card_cpu)
    for kname, k in kernels.items():
        k["launches"] += launches.get(kname, 0)

    torch.cuda.empty_cache()
    launches = frontends_phase(dev)
    for kname, k in kernels.items():
        k["launches"] += launches.get(kname, 0)

    torch.cuda.empty_cache()
    launches = paper_phase(dev, paper_s)
    for kname, k in kernels.items():
        k["launches"] += launches[kname]

    t = time.perf_counter()
    specs_s, traced = dry_specs.result(), dry_checks.result()
    for pool in dry:
        pool.shutdown()
    log(f"waited {time.perf_counter() - t:.1f} s for phase 4d's traces "
        f"({specs_s:.1f} s for (a), {traced['s']:.1f} s for the rest)")
    dryrun_compare(traced["full"], real_b)
    dryrun_collectives_check(traced["entries"], b_entries)

    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s in all, on "
        f"{card_line()}")
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
