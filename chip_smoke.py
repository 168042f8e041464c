#!/usr/bin/env python3
"""Drive the port's batched GET on one NVIDIA card and check every kernel.

  python3 chip_smoke.py [--keys N] [--shard-keys N] [--seed S]
                        [--first-version DIR]

1. Builds the CUDA kernels of ``port/repro_torch/kernels/csrc`` with nvcc
   (sm_90a) and prints ptxas's register and spill report.
2. Drives ``repro_torch``'s in-memory ``BourbonStore`` (default LSMConfig,
   filters on, values fetched) through three phases of batched GETs, each
   answer checked against ground truth:
     A  unlearned files (engine mode ``model``: both descent arms);
     B  after ``learn_all`` (mode ``model_pure``: the learned arm only);
     C  after 1% fresh puts, 1% overwrites and 1% deletes (mode ``model``),
        with a 65536-key batch and small batches the host answers.
   Kernel launch counts are zeroed just before phase A and read just after
   phase C; each kernel of the path must have launched.
3. Drives the durable sharded GET the serving plane sits on: a
   ``ShardedStore`` of 4 level-granularity shards in a temporary directory
   (the shard config of benchmarks/bench_dist_recovery.py, ``--shard-keys``
   ``make_dataset("ar")`` keys, the last 4096 only in the WALs):
     D  32 GETs of 4096 keys (values fetched) through the filter-plane
        stack probe and the shard descent; then the store is dropped
        without close(), reopened from its directories alone, and the
        GETs repeat;
     E  one shard's own GET in engine mode "level" on its recovered level
        models, and one direct engine lookup whose filter mask the card
        probes (no host mask), held to the host-mask lookup.
   Counts are zeroed just before phase D and read just after phase E;
   ``bloom_probe_stack``, ``plr_lookup`` and ``bounded_search`` must have
   launched.
   After the kernel checks below have read that store:
     F  the served GET, ``repro_torch.server`` over the same store:
        64 async closed-loop clients (two requests outstanding each, 32
        keys a request, 80% of them from a hot tenth of the keys, a
        quarter of the rest absent), 36 rounds of which the first 4 are
        untimed, in five arms, each a fresh server: ``BourbonServer``;
        ``PipelinedServer``; the same with an I/O pool of 2 workers; that
        with the obs plane on; that with 5% of the requests PUTs of
        present keys.  Arms 1-4 run five times each, in turns, for the
        spread of their rates; arm 5 runs once, last.  Every answer is
        checked, arms 1-4 must answer byte for byte alike, the pipelined
        arms must overlap batches with no epoch violation, the obs arms'
        counters must reconcile with the served totals and their trace
        hold device_compute and value_fetch spans.  Counts are zeroed
        just before F and read just after; the same three kernels must
        have launched.  Then those three are held against their plain
        versions on probes F dispatched, at the batch sizes it sent.
     G  the mesh GET (phases D-F run without a mesh, whatever the
        machine): D's store is closed and reopened on a mesh of one
        device a shard — four distinct cards when there are four, else
        cuda:0 four times — and D's 32 batches replay, every answer
        checked and byte for byte equal to the same batches on the same
        store without a mesh; F's arms 1-2 serve once each over it; and
        ``port/examples/distributed_get.py`` runs at ``--shard-keys`` keys
        over every visible card.  Counts are zeroed just before G and read
        just after: the three kernels must launch once a mesh device a
        mesh GET.  Then they are held against their plain versions at G's
        one-row shapes, on every mesh device's shard row.
     H  the served LM: ``repro_torch.serving.ServingEngine`` with
        qwen2-0.5b at full width in bf16 (``init_params`` from a generator
        seeded ``--seed``), 256 sequences at a time over a 1024-token
        cache, and a ``SessionStore`` index preloaded with H_SESSIONS
        (1,048,576) live background sessions: uniform signed 64-bit ids in
        register batches of 4096, 10% of each batch evicted a batch later.
        H_REQUESTS (256) requests of 3-9 prompt tokens and 16 new
        tokens run until drained, another 4096 background sessions
        registered every 8 engine steps (flushing the active sessions out
        of the memtable, as other engines sharing the index would); then
        32 direct lookups of 4096 ids, half live and half absent.  Every
        lookup, the engine's and the direct ones, is checked against a
        ground-truth dict of registered minus evicted sessions; every
        request must finish with 16 tokens and every page return to the
        pool; 8 engine steps run under torch.profiler.  At the same width,
        8 sequences of 16 tokens decoded step by step are held to
        ``forward`` over the same tokens, and their first 4 steps to the
        same port in f32 on the CPU from the same parameters, within
        H_LOGIT_TOL of the largest logit.  Counts are zeroed just before
        the serving and read after the direct lookups: ``plr_lookup``,
        ``bounded_search``, ``bloom_probe`` and ``sstable_search`` must
        have launched; then they are held against their plain versions on
        every level of the session index, on the id batches H looked up.
     I  the served MoE/MLA model over H's session index: H's model is
        freed, and deepseek-v2-lite-16b at full width and cut depth (7 of
        27 layers, I_SERVE_UNITS: MLA attention over its compressed
        cache, the dense MLP layer, 6 of the 26 MoE layers of 64 experts,
        top-6, 2 shared) in bf16 serves I_REQUESTS (256) requests like H's
        through ``ServingEngine`` with H's engine config, registering H's
        remaining background batches, every lookup and request checked as
        in H, 8 engine steps profiled, and the MoE assignments dropped at
        capacity counted (of all rows, and of the rows that carried a real
        token).  Counts are zeroed just before I's serving and read just
        after: the four descent kernels must have launched, and are held
        against their plain versions on the id batches I looked up.  Then
        I2, in f32 at full width and cut depth (deepseek 3 layers,
        mixtral-8x22b 1, llama-3.2-vision-11b 5 with its gates at 0.5):
        ``forward`` and 4 decode steps on the card against the CPU within
        I_F32_TOL of the largest logit; deepseek's ``mla_decode`` step by
        step against ``mla_attention`` within I_MLA_TOL; and deepseek in
        bf16 against f32, the share of positions whose top-k routing
        differs (a reading, no bound).
     J  the served recurrent model over the same index: I's model is
        freed, and hymba-1.5b at full width and cut depth (8 of 32
        ``hybrid`` layers, J_SERVE_UNITS: sliding-window GQA attention and
        Mamba heads in parallel) in bf16 serves J_REQUESTS (256) requests like
        I's, registering the background batches I left, every lookup and
        request checked, 8 engine steps profiled; its cache bytes split
        into the attention ring and the Mamba state.  Counts are zeroed
        just before J's serving and read just after: the four descent
        kernels must have launched, and are held against their plain
        versions on the id batches J looked up.  Then J2, in f32 at full
        width and cut depth (hymba 2 layers, xlstm-1.3b one unit of 7
        mLSTM and 1 sLSTM layers): ``forward`` over 2 x 8 tokens and over
        2 x 1024 (hymba) or 2 x 512 (xlstm) tokens, the chunked side of
        each threshold, and 4 decode steps on the card against the CPU
        within J2_F32_TOL of the largest logit (I2's bound for hymba;
        for xlstm, set between the sound port's readings over four seeds,
        beside its own float32 sensitivity, the CPU logits' move under
        one ulp of noise on the embeddings, and those with TF32 products
        on the card); and 8 decode steps on the card against ``forward``
        within J2_DECODE_TOL.
     K  training: qwen2-0.5b at full width and depth (24 layers,
        494,032,768 parameters) in bf16 with the f32 master copy
        (``AdamWConfig()``), trained by ``repro_torch.train.Trainer`` over
        ``synthetic_tokens`` in sequences of 1024 tokens, 8 a step, remat
        "none", in a temporary directory removed at the end: run 1
        checkpoints at step 6 and stops at an injected failure at step 9;
        run 2 restores step 6's checkpoint, every leaf held bit for bit to
        the host tree run 1 wrote (bf16 leaves as bf16), and trains to
        step 11, its steps 8-11 under torch.profiler.  Every loss must be
        finite and step 11's below step 0's.  Its line has steps/s and
        tokens/s (median step), the losses and grad norms, the device idle
        share over the profiled steps, peak device bytes, a checkpoint's
        bytes, its save, snapshot and restore seconds and the free disk
        space.  Counts are zeroed just before K and read just after: the
        training path runs none of the five kernels (``launches_k``).
        Then K2, in f32 at full width and cut depth (qwen2-0.5b and
        hymba-1.5b, 2 layers each), TF32 off: ``loss_fn`` and every
        gradient leaf on the card (remat "full") against the CPU (remat
        "none") from the same parameters, and one ``adamw_update`` on
        identical trees, within K2_LOSS_TOL, K2_GRAD_TOL and K2_ADAMW_TOL.
        Last, ``port/examples/quickstart.py``, ``serve_kv_cache.py`` and
        ``train_lm.py`` (200 steps of a d 512, 8-layer model) run as
        processes of their own on the card and must print the reference
        examples' facts (EXAMPLES).
     L  the launch layer.  L1: ``python -m repro_torch.launch.dryrun
        --store`` as a process of its own: the paper's workload on the
        production (16, 16) mesh of the card repeated, 2^30 keys in 256
        shard rows of 2^22 (16 GiB of keys and value pointers), three GETs
        of 2^20 probes (half absent) through ``build_dist_get``, every
        answer checked against the state's closed form (each row a PLR
        model of 512 segments that misplaces keys by up to delta); its
        launches (``launches_l``) must be one ``plr_lookup`` and one
        ``bounded_search`` a mesh position a GET, and the two kernels are
        then held against their plain versions on position 0's row at
        2^20 probes, the GET's gathered batch (``store_shape``) and probes
        of the row's own keys (``store_row_shape``); its line has the
        plan's bytes a position beside the measured peak and the GET
        times.  L2: the dry run's plans (``meta``, no memory) of
        qwen2-0.5b x train_4k, deepseek-v2-lite-16b x decode_32k and
        hymba-1.5b x long_500k on the (16, 16) mesh at full width and
        depth, qwen2 again at units 1 and 2 (extrapolated, they must give
        its full plan's FLOPs), hymba on the (2, 16, 16) mesh, and
        ``roofline.report`` over them.  L3: two train steps of qwen2-0.5b at full width under
        ``DEFAULT_RULES`` on a (1, 1) mesh of the card, bit for bit the
        same steps with ``rules=None``.
     M  the sharded serve step (``launch/spmd``, ``launch/steps``):
        command-r-plus-104b at full width on a (data 2, model 2) mesh of
        four processes under ``DEFAULT_RULES``, every parameter, cache and
        input a DTensor (one card a rank over NCCL with four cards, else
        all four on cuda:0 over gloo, the collectives staged through host
        memory; the backend and the number of cards are printed).  M1 in
        bf16, 4 of its 64 units (the one cut); M2 in f32, one unit.  Each:
        a prefill of 8 prompts of 128 tokens, then 8 decode steps at 8
        rows on from caches of 1024 whose first 508 slots are written
        (drawn from ``--seed``), so that the steps write slots 508-515,
        both pieces of the context split over "model"; the tokens fed
        drawn from ``--seed``;
        then the same unsharded in this process once the four have
        exited.  Each step's largest logit gap over the unsharded logits'
        largest magnitude must stay within M_TOL; each rank's parameter
        bytes must equal the dry-run plan's (``plan_cell``, the same
        config and cell on a (2, 2) mesh of ``meta``).  Its lines have
        the wall ms a step of both runs, the collectives by kind
        (CommDebugMode) and the plan's, and each rank's peak device
        bytes.
     N  the sharded serve step of the MoE and MLA blocks, on M's mesh,
        launcher and steps (its ranks run in the same spawn as M's,
        after them): N1 deepseek-v2-lite-16b at full width in bf16, its
        dense prologue layer and 3 of its 26 MoE units (``mla_dense``,
        ``mla_moe``: MLA's compressed cache split over "model", 64
        experts top-6, 2 shared); N2 mixtral-8x22b at full width in f32,
        one unit (``attn_moe``: its 4096-slot window ring of 1024 split
        over "model", 8 experts top-2), the last 4 of its 8 prompts one
        repeated token id, so that the 1024-token group's capacity (320)
        drops assignments on the second data rank's tokens; N3 N1's
        deepseek in f32, its prologue layer and one MoE unit.  Each as M:
        prefill 8 x 128, 8 decode steps on from 508 written slots of
        1024, within N_TOL of the unsharded run, each rank's parameter
        bytes the plan's; its line adds, for every MoE layer's routing,
        the (layer, token) positions whose top-k experts differ between
        the two runs and the assignments each dropped, prefill and decode
        apart, for each MoE layer the unsharded run's largest margin
        between the k-th and the next expert's probability at the
        positions that differ, and which MoE calls moved the tokens'
        rows to the expert weights.  N2 and N3 (f32) must route every
        token alike; N2 must drop as many on both sides, more than 0.
     O  the sharded serve step of the recurrent and cross-attention
        blocks, on M's mesh, launcher and steps (its ranks in the same
        spawn, after N's): O1 hymba-1.5b at full width in bf16, 2 of its
        32 ``hybrid`` layers (attention and Mamba heads side by side; its
        window ring of 1024 split over "model"); O2 hymba in f32, one
        layer; O3 xlstm-1.3b at full width in f32, one unit (7 ``mlstm``,
        1 ``slstm``; the mLSTM state C split on its hd, 1024 = T, as the
        reference's cache rule says); O4 llama-3.2-vision-11b at full
        width in f32, one unit (4 ``attn_mlp``, 1 ``cross_attn_mlp``),
        its gates at 0.5 and 1600 bf16 image embeddings a row drawn from
        ``--seed``, split over the batch.  Each as M: prefill 8 x 128, 8
        decode steps on from 508 written slots of 1024 (every recurrent
        state drawn from ``--seed`` too), within O_TOL of the unsharded
        run, each rank's parameter bytes the plan's.
        Counts are zeroed just before M and read just after O
        (``launches_m``, ``launches_n``, ``launches_o``); the model path
        runs none of the five kernels, and a launch there fails the
        run.
     P  the sharded train step (``build_train_step`` on the process
        mesh: the parameters and the AdamW state DTensors, the batch
        split over "data"), on M's mesh and launcher, remat "full", 3
        AdamW steps of 8 x 128 tokens from the seed, each run first
        unsharded on cuda:0 from the same draw by rank 0 while the other
        ranks wait (its state saved to disk, the model freed before the
        ranks' run; one run's state on disk at a time): P1 qwen2-0.5b at full width
        in bf16 with the f32 master, 2 of its 24 layers (``P_RUNS``), which
        checkpoints after step 2 on the mesh (rank 0 writes the gathered
        leaves) and whose step 3, redone by fresh ranks from that
        checkpoint, must equal the uninterrupted one bit for bit (every
        rank's every piece); P2 qwen2 in f32, 1 layer, microbatch 2; P3
        deepseek-v2-lite-16b in f32, its dense layer and one MoE unit,
        whose aux loss must be nonzero and match the unsharded one's
        within P_AUX_TOL.  Each line has the loss and grad-norm gaps
        (within P_TOL's "metrics"), the largest gap of m and v after the
        first step, where both runs route alike (the gradient's witness:
        within P_TOL's "step1"), and of the parameters, master, m and v
        after the last step, of each leaf's largest magnitude (within
        P_TOL's "leaves"), the collectives of a step by kind and their
        bytes (``plan.ShardMeter``), ms a step both ways, the peak device
        bytes a rank, each rank's parameter and optimizer bytes against
        the plan's (equal), and for P3 which side of the MoE byte rule
        each call took and, step by step, the tokens whose experts differ
        between the two runs.
     Q  the sharded train step of the recurrent and cross-attention
        blocks, P's runs in P's spawn: Q1 hymba-1.5b at full width in
        bf16 with the f32 master, 2 of its 32 layers, its window as
        published; Q2 xlstm-1.3b in f32, one of its 6 units (7 ``mlstm``,
        1 ``slstm``), whose sLSTM time loop must issue no collective in
        step 1 (``SlstmLoopMeter``: its forward, its recomputation and
        its backward); Q3 llama-3.2-vision-11b in f32, one of its 8
        units (4 ``attn_mlp``, 1 ``cross_attn_mlp``), its gates at 0.5
        and 1600 image embeddings a row drawn from the seed (bf16, split
        over "data").  Each line as P's, within P_TOL.
        Counts are zeroed just before P and read just after Q
        (``launches_p``, ``launches_q``): the train path runs none of the
        five kernels, and a launch there fails the run.
     R  the port's correctness gates in process on the card
        (``drive_gates``, sizes in R_GATES): R1
        ``port/scripts/check_filter_zero_fn.py`` at 4096 keys (the
        reference gate's stores, keys and requests) and at 1,048,576 keys
        (the default LSMConfig): filters off against filters on, byte for
        byte, the filters-on durable store reopened with no filter
        rebuilt; R2 ``port/scripts/check_io_determinism.py`` at 4096 and
        262,144 keys: the pipelined server over a durable sharded store
        with the group-commit WAL at ``io_workers`` 0, 1 and 4, byte for
        byte with no epoch violation (pool workers resolve batches whose
        kernels this thread launched).  Each gate's line has its counts
        (requests, probes, screened, host-answered, filters rebuilt,
        epoch violations), each arm's seconds and its launches, zeroed
        just before the gate and read just after.  A gate's non-zero
        status fails the run, as does a gate that launched none of the
        four descent kernels; the kernels are then held against their
        plain versions on the probes each arm dispatched, before its
        store closes (``gate_shape_r1``, ``gate_shape_r2``).
   After the timed batches of C, D, E and G, 4 of the phase's batches
   replay through its dispatch half (``BourbonStore.dispatch_get`` in C,
   ``ShardedStore.dispatch_get`` in D and G, and in E shard 0's
   ``dispatch_get`` and ``LookupEngine.lookup_async`` with the device
   filter probe), one at a time in this thread with no I/O-pool worker
   alive, each under ``torch.cuda.set_sync_debug_mode("warn")`` with the
   warnings recorded; each resolves after the mode is reset and every
   answer is checked.  Before the first replayed batch of each store's
   dispatch the store forgets its device state, so that batch restacks
   and uploads it as the first dispatch after a structure change does;
   the other three are steady-state batches, each behind 200 ms of device
   sleep that it must return ahead of.  A replayed batch that
   synchronizes or waits fails the run, naming the call.  The
   ``hot_syncs`` line gives per phase the syncs the card saw and the
   port's HOTSYNC findings (``repro_torch.analysis``) in the functions
   those halves ran, with how many of those functions the rule checks.
4. Holds each kernel against its plain PyTorch version on the same CUDA
   tensors at the live state's shapes (4096 probes; the stack probe at
   both of its live shapes; ``plr_lookup`` also at phase D's stacked shard
   tables and phase E's one-row level model; ``bounded_search`` also at
   δ = 40 and ``bloom_probe`` at k = 12; the three kernels of phase F also
   at the batch sizes F dispatched, on its probes; the four descent
   kernels also at phase H's session index, on H's, I's and J's batches;
   ``plr_lookup`` and ``bounded_search`` also at phase L1's shard row, on
   its GET batches of 2^20 probes; and those phase R launched, on the
   probes its gates dispatched),
   times both with CUDA events and torch.profiler, and computes the
   kernel's lower bound from the bytes its probes must gather and the
   per-launch floor (the device time of one trivial PyTorch kernel over
   4096 elements).
5. With ``--first-version DIR`` (a directory holding earlier sources of
   any of the five kernels, ``<name>.cu``): builds them into a library of
   their own and times each against its current build in turns (first,
   current, current, first) on the same tensors (the stack probe at both
   of its live shapes), and times the lane-group kernels built with groups
   of 8, 16 and 32 lanes a probe (8, 16, 32, 32, 16, 8): ``bounded_search``
   at δ 8 and 40, ``sstable_search`` at L3 and ``plr_lookup`` at L3 and at
   phase E's level model; and the stack probe built with 1, 2, 4 and 8
   lanes a (row, probe) (1, 2, 4, 8, 8, 4, 2, 1) at both of its shapes.
   Every build is held to the plain version first.

Output: one line per phase, a ``{"hot_syncs": {...}}`` JSON line, a
``{"kernels": [...]}`` JSON line, the card's name and power limit from
nvidia-smi, and last the ``{"ok": true, ...}`` JSON line.  Exits
non-zero, printing no result, when there is no CUDA device, when the
port's package is missing, or on the first wrong answer.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses
import gc
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
NONTENSOR_OPS_PER_S = 67e12    # H100 SXM non-tensor FP32 rate (data sheet)
CHECK_B = 4096                 # probes per kernel launch in the checks
TIMED_BATCHES = 32             # distinct probe sets rotated while timing
TIMED_ROUNDS = 4
PROFILE_TRIES = 3              # profiled passes at most, for a whole one
WIDE_DELTA = 40                # window wider than one warp's group
WIDE_K = 12                    # more hashes than one group of 8 lanes
GROUPS = (8, 16, 32)           # lanes per probe of the group kernels, timed
STACK_GROUPS = (1, 2, 4, 8)    # lanes per (row, probe) of the stack probe
SYNC_REPLAYS = 4               # batches replayed through a dispatch half
DEVICE_HOLD_MS = 200.0         # device sleep queued ahead of each replay
HERE = os.path.dirname(os.path.abspath(__file__))
PORT_SRC = os.path.join(HERE, "port", "repro_torch")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------------
# the dispatch halves under torch's sync debug mode
# ----------------------------------------------------------------------------

class SyncWatch:
    """While installed: torch's sync debug mode at "warn" (on the card),
    each synchronizing CUDA call recorded with the innermost frame of the
    port that made it, and the port's functions that ran (a profile
    hook).  The mode is process-wide: the caller runs nothing on another
    thread meanwhile."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.syncs, self.funcs = [], set()

    def __enter__(self):
        import torch
        self._caught = warnings.catch_warnings()
        self._caught.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._show
        sys.setprofile(self._called)
        if self.on_card:
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch
        if self.on_card:
            torch.cuda.set_sync_debug_mode("default")
        sys.setprofile(None)
        self._caught.__exit__(*exc)

    def _called(self, frame, event, arg):
        code = frame.f_code
        if event == "call" and code.co_filename.startswith(PORT_SRC):
            self.funcs.add((os.path.relpath(code.co_filename, HERE),
                            code.co_qualname.replace(".<locals>", "")))

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return                 # e.g. the mode's own prototype notice
        port = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(PORT_SRC)]
        self.syncs.append(
            f"{os.path.relpath(port[-1].filename, HERE)}:{port[-1].lineno} "
            f"({port[-1].name}): {port[-1].line}" if port
            else f"{filename}:{lineno}")


def store_token(store) -> tuple:
    """What a ``BourbonStore``'s dispatch reads as device state: the
    engine's stacked levels, level models and filter stack, and the value
    log's device copy.  A dispatch that changes it rebuilt state."""
    eng = store.engine
    return (tuple(map(id, eng._state_cache.values())),
            tuple(map(id, eng._lm_cache.values())), id(eng._filter_cache),
            id(getattr(store.vlog, "_device", None)))


def drop_device_state(store) -> None:
    """Forget what a store's dispatch uploaded (a ``BourbonStore``'s
    stacked levels, level models, filter stack and value-log copy; a
    ``ShardedStore``'s stacked or mesh-placed rows), so that its next
    dispatch restacks and uploads all of it, as the first dispatch after a
    structure change does."""
    if hasattr(store, "shards"):
        store._state = None
        return
    eng = store.engine
    eng._state_cache.clear()
    eng._lm_cache.clear()
    eng._filter_cache = None
    store.vlog._device = None


class HotSyncs:
    """The dispatch-half replays of one run: each phase's records by half,
    the port functions its halves ran, HOTSYNC's findings over the port
    (read once) and the calibrated device sleep."""

    def __init__(self):
        self.records: dict = {}      # phase -> {half: record}
        self.funcs: dict = {}        # phase -> {(path, function)}
        self._static: dict | None = None
        self._hot: dict | None = None    # path -> registered hot qualnames
        self._hold: int | None = None

    def static(self) -> dict:
        """HOTSYNC's findings over ``port/repro_torch`` that no justified
        allow suppresses, by (path, function), from the port's own
        rule."""
        if self._static is None:
            from repro_torch.analysis import HotSyncRule, run_lint
            self._static = {}
            for f in run_lint([PORT_SRC], [HotSyncRule()], root=HERE):
                if f.rule == "HOTSYNC" and not f.suppressed:
                    self._static.setdefault((f.path, f.symbol),
                                            []).append(f.render())
        return self._static

    def checks(self, func: tuple) -> bool:
        """Whether HOTSYNC checks the port function ``(path, qualname)``:
        a registered hot function or one nested in it."""
        if self._hot is None:
            from repro_torch.analysis.core import (iter_py_files, match_hot,
                                                   walk_functions)
            from repro_torch.analysis.hotsync import DEFAULT_HOT_FUNCTIONS
            self._hot = {}
            for path in iter_py_files([PORT_SRC]):
                with open(path) as fh:
                    tree = ast.parse(fh.read())
                self._hot[os.path.relpath(path, HERE)] = [
                    qual for qual, cls, fn in walk_functions(tree)
                    if match_hot(DEFAULT_HOT_FUNCTIONS, cls, fn.name)]
        path, qual = func
        return any(qual == h or qual.startswith(h + ".")
                   for h in self._hot.get(path, ()))

    def hold_cycles(self) -> int:
        """Cycles of ``torch.cuda._sleep`` that keep the current stream busy
        for about DEVICE_HOLD_MS, calibrated once with CUDA events."""
        if self._hold is None:
            import torch
            n = 1 << 24
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            torch.cuda._sleep(n)
            b.record()
            b.synchronize()
            self._hold = int(n * DEVICE_HOLD_MS / a.elapsed_time(b))
        return self._hold

    def replay(self, phase: str, half: str, dispatch, resolve,
               batches: list, token, on_card: bool, restack=None) -> dict:
        """Replays ``batches`` one at a time through the dispatch half
        ``dispatch`` under :class:`SyncWatch`, and resolves each with
        ``resolve(pending, probes)`` (which checks every answer) after the
        mode is reset.  ``restack()``, when given, drops the half's device
        state before the first batch, so that batch restacks and uploads
        it as the first dispatch after a structure change does; ``token()``
        names the device state, and must change on that batch and on no
        other.  A batch that synchronized fails the run, naming the call.
        On the card each steady-state dispatch also starts behind
        DEVICE_HOLD_MS of device sleep on its stream, and must return while
        the sleep still runs: a wait for the device that the sync debug
        mode does not see (it is a prototype) shows there; the restacking
        batch's return is only recorded.  The record also counts the port's
        HOTSYNC findings in the functions the half ran, and lists those of
        them the rule does not check."""
        import torch
        rec = {"batches": len(batches), "syncs": 0, "state_rebuilds": 0,
               "rebuild_syncs": 0, "returned_while_device_busy": 0,
               "rebuild_returned_while_device_busy": None,
               "device_hold_ms": DEVICE_HOLD_MS if on_card else None,
               "dispatch_ms": []}
        funcs = set()
        for bi, p in enumerate(batches):
            restacks = bi == 0 and restack is not None
            if restacks:
                restack()
            before = token()
            if on_card:
                torch.cuda._sleep(self.hold_cycles())
                busy = torch.cuda.Event()
                busy.record()
            t0 = time.perf_counter()
            with SyncWatch(on_card) as w:
                pending = dispatch(p)
            rec["dispatch_ms"].append(1e3 * (time.perf_counter() - t0))
            held = on_card and not busy.query()
            rebuilt = token() != before
            resolve(pending, p)
            funcs |= w.funcs
            if rebuilt != restacks:
                fail(f"phase {phase}: {half} "
                     + (f"rebuilt its device state on replayed batch {bi} "
                        f"with no structure change" if rebuilt else
                        "did not restack the device state it was made "
                        "to drop"))
            if restacks:
                rec["state_rebuilds"] += 1
                rec["rebuild_syncs"] += len(w.syncs)
                rec["rebuild_returned_while_device_busy"] = held
            else:
                rec["syncs"] += len(w.syncs)
                rec["returned_while_device_busy"] += held
            if w.syncs:
                fail(f"phase {phase}: {half} synchronized {len(w.syncs)} "
                     f"times in {'restacking' if restacks else 'steady-state'}"
                     f" batch {bi}, first at {w.syncs[0]}")
            if on_card and not held and not restacks:
                fail(f"phase {phase}: {half} returned from steady-state batch "
                     f"{bi} only after the {DEVICE_HOLD_MS} ms of device work "
                     f"queued before it had finished: it waited for the "
                     f"device")
        static = self.static()
        checked = {f for f in funcs if self.checks(f)}
        rec.update(static_findings=sum(len(static.get(f, ())) for f in funcs),
                   functions=len(funcs),
                   hot_functions=sorted(sym for _, sym in checked),
                   unchecked=sorted(sym for _, sym in funcs - checked),
                   sync_debug_mode="warn" if on_card else None)
        self.records.setdefault(phase, {})[half] = rec
        self.funcs.setdefault(phase, set()).update(funcs)
        return rec

    def line(self) -> dict:
        """The hot_syncs record: per phase, the syncs the card saw in its
        dispatch halves (steady-state batches, and the batch that
        restacked the device state), the HOTSYNC findings in the functions
        they ran, how many port functions ran and how many of them the
        rule checks, with each half's record."""
        static = self.static()
        out = {}
        for phase, halves in self.records.items():
            funcs = self.funcs[phase]
            out[phase] = {
                "syncs": sum(r["syncs"] for r in halves.values()),
                "rebuild_syncs": sum(r["rebuild_syncs"]
                                     for r in halves.values()),
                "static_findings": sum(len(static.get(f, ()))
                                       for f in funcs),
                "functions_run": len(funcs),
                "functions_checked": sum(map(self.checks, funcs)),
                "halves": halves}
        return out


# ----------------------------------------------------------------------------
# the main path
# ----------------------------------------------------------------------------

class Truth:
    """Ground truth of the key space: what each key must read back as."""

    def __init__(self, keys: np.ndarray, value_size: int):
        self.keys = keys                     # sorted present keys
        self.value_size = value_size
        self.ow_keys = np.zeros(0, np.int64)  # sorted overwritten keys
        self.ow_vals = np.zeros((0, value_size), np.uint8)
        self.dead = np.zeros(0, np.int64)     # sorted deleted keys

    @staticmethod
    def _isin(sorted_keys: np.ndarray, q: np.ndarray) -> np.ndarray:
        if sorted_keys.shape[0] == 0:
            return np.zeros(q.shape, bool)
        i = np.minimum(np.searchsorted(sorted_keys, q), sorted_keys.shape[0] - 1)
        return sorted_keys[i] == q

    def absent(self, rng, n: int) -> np.ndarray:
        lo, hi = int(self.keys[0]), int(self.keys[-1])
        out = np.zeros(0, np.int64)
        while out.shape[0] < n:
            c = rng.integers(lo, hi, size=2 * n, dtype=np.int64)
            out = np.concatenate([out, c[~self._isin(self.keys, c)]])
        return out[:n]

    def overwrite(self, keys, values) -> None:
        """Record PUTs of present keys, the last value of a key winning."""
        ks = np.concatenate([self.ow_keys, keys])
        vs = np.concatenate([self.ow_vals, values])
        last = ks.shape[0] - 1 - np.unique(ks[::-1], return_index=True)[1]
        self.ow_keys, self.ow_vals = ks[last], vs[last]

    def check(self, tag: str, probes, found, values) -> None:
        live = self._isin(self.keys, probes) & ~self._isin(self.dead, probes)
        if not np.array_equal(found, live):
            bad = np.flatnonzero(found != live)
            fail(f"{tag}: {bad.shape[0]} found flags wrong, first key "
                 f"{int(probes[bad[0]])} found={bool(found[bad[0]])}")
        want = np.zeros((probes.shape[0], self.value_size), np.uint8)
        want[:, 0] = (probes & 0xFF).astype(np.uint8)
        ow = self._isin(self.ow_keys, probes) & live
        if ow.any():
            want[ow] = self.ow_vals[np.searchsorted(self.ow_keys, probes[ow])]
        want[~live] = 0
        if not np.array_equal(values, want):
            bad = np.flatnonzero((values != want).any(axis=1))
            fail(f"{tag}: {bad.shape[0]} values wrong, first key "
                 f"{int(probes[bad[0]])}")


def run_gets(store, truth: Truth, batches: list, tag: str) -> dict:
    """GET every batch and check each against the truth.  The first batch
    after a structure change pays one-time work (level filters built on
    the host, levels and the value log copied to the card), so it is timed
    apart; ``gets_per_s`` is the host wall clock over the other batches'
    ``get_batch`` calls alone (checks excluded).  ``launches`` counts the
    kernel launches of these batches."""
    from repro_torch.kernels import ops
    launched = dict(ops.launches)
    model0, base0 = store.lookups_model_path, store.lookups_baseline_path
    hits = live = 0
    secs = []
    for bi, probes in enumerate(batches):
        t0 = time.perf_counter()
        found, values = store.get_batch(probes)
        secs.append(time.perf_counter() - t0)
        truth.check(f"{tag} batch {bi}", probes, found, values)
        hits += int(found.sum())
        live += int((Truth._isin(truth.keys, probes)
                     & ~Truth._isin(truth.dead, probes)).sum())
    n_rest = sum(p.shape[0] for p in batches[1:])
    dm = store.lookups_model_path - model0
    db = store.lookups_baseline_path - base0
    per = sorted(secs[1:])
    return {"gets": sum(p.shape[0] for p in batches), "batches": len(batches),
            "first_batch_s": secs[0], "gets_per_s": n_rest / sum(secs[1:]),
            "batch_ms_median": 1e3 * per[len(per) // 2],
            "batch_ms_max": 1e3 * per[-1],
            "hit_rate": hits / max(live, 1),
            "model_path_frac": dm / max(dm + db, 1),
            "launches": {k: v - launched[k] for k, v in ops.launches.items()}}


def host_profile(get, batches: list) -> dict:
    """Where a GET batch's host time goes: cProfile over a few batches,
    the functions with the most self time (cProfile adds its own cost per
    Python call, so read the shares, not the absolute times)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    for probes in batches:
        get(probes)
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(((tt, nc, f"{os.path.basename(fn)}:{ln}({name})")
                   for (fn, ln, name), (_, nc, tt, _, _) in st.stats.items()),
                  reverse=True)
    return {"batches": len(batches), "total_s": st.total_tt,
            "top_self": [{"fn": f, "calls": c, "s": t} for t, c, f in rows[:10]]}


def profile_gets(get, batches: list) -> dict:
    """Device time of a few GET batches under torch.profiler: total kernel
    time against the wall clock, and the kernels that took the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for probes in batches:
            get(probes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"batches": len(batches), **device_summary(prof, wall)}


def device_summary(prof, wall: float) -> dict:
    """A finished torch.profiler session's device time against the wall
    clock: busy seconds, the idle share, and the kernels that took the
    most."""
    from torch.autograd import DeviceType

    dev = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            dev.append((us, e.count, e.key))
    dev.sort(reverse=True)
    busy = sum(us for us, _, _ in dev) / 1e6
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": (1 - busy / wall) if busy else None,
            "top_device": [{"name": k[:60], "calls": c, "us": us}
                           for us, c, k in dev[:8]]}


def phase_line(tag: str, store, res: dict, card: str, extra: dict) -> None:
    import torch
    files = [len(lvl) for lvl in store.tree.levels]
    dev_bytes = (torch.cuda.max_memory_allocated()
                 if store.engine.device.type == "cuda" else 0)
    learned = [sum(t.model is not None for t in lvl)
               for lvl in store.tree.levels]
    rec = {"phase": tag, "mode": store._engine_mode(),
           "keys": store.tree.total_records(), "files_per_level": files,
           "learned_per_level": learned,
           "device_max_bytes": dev_bytes, **res, **extra, "card": card}
    print(json.dumps(rec))


def load_store(device: str, n_keys: int, seed: int) -> tuple:
    """Phase A's host LSM load: ``n_keys`` OSM-like keys in a seeded random
    order into an in-memory ``BourbonStore`` (default LSMConfig, filters
    on, values fetched, ``offline``), in put batches of 1M, then flushed.
    Returns the store and the sorted keys."""
    from repro_torch.core import BourbonStore, StoreConfig, make_dataset

    store = BourbonStore(StoreConfig(mode="bourbon", policy="offline",
                                     fetch_values=True, device=device))
    keys = make_dataset("osm", n_keys, seed=seed)
    perm = np.random.default_rng(seed).permutation(keys)
    for off in range(0, n_keys, 1 << 20):
        store.put_batch(perm[off: off + (1 << 20)])
    store.flush_all()
    return store, keys


def drive(device: str, n_keys: int, seed: int, card: str,
          batch: int = 4096, n_batches: int = 64, *,
          hot: HotSyncs) -> object:
    """Phases A-C of the main path on ``device``, C's dispatch half
    replayed into ``hot``.  Returns the store, the kernel launch counts of
    phases A-C, and (level, device level, tables) of the widest level as
    phase B served it, for the kernel checks."""
    import torch

    t0 = time.perf_counter()
    store, keys = load_store(device, n_keys, seed)
    load_s = time.perf_counter() - t0
    truth = Truth(keys, store.cfg.value_size)

    def batches(r, count, size):
        out = []
        for _ in range(count):
            out.append(np.concatenate([r.choice(truth.keys, size // 2),
                                       truth.absent(r, size - size // 2)]))
        return out

    from repro_torch.kernels import ops
    ab = batches(np.random.default_rng(seed + 1), n_batches, batch)
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                      # the main path starts here
    res = run_gets(store, truth, ab, "A")
    phase_line("A", store, res, card, {"load_s": load_s})

    t0 = time.perf_counter()
    learned = store.learn_all()
    learn_s = time.perf_counter() - t0
    if store._engine_mode() != "model_pure":
        fail("phase B: not every file is learned")
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    res = run_gets(store, truth, ab, "B")
    if device != "cpu":
        res["profile"] = profile_gets(store.get_batch, ab[:8])
    res["host_profile"] = host_profile(store.get_batch, ab[:8])
    phase_line("B", store, res, card, {"learned": learned, "learn_s": learn_s})
    # the kernel checks run on the widest level as phase B served it, with
    # every file learned (phase C's compactions leave files unlearned)
    state = store.engine.build_state(store.tree)
    li = max(range(1, len(state.levels)),
             key=lambda i: (state.levels[i].n_files, i))
    snapshot = (li, state.levels[li], list(store.tree.levels[li]))

    # phase C: 1% fresh keys, 1% overwrites, 1% deletes; new files unlearned
    r = np.random.default_rng(seed + 2)
    k1 = max(1, n_keys // 100)
    fresh = np.unique(truth.absent(r, k1))
    pick = r.choice(n_keys, 2 * k1, replace=False)
    ow = np.sort(keys[pick[:k1]])
    dead = np.sort(keys[pick[k1:]])
    ow_vals = r.integers(0, 256, (ow.shape[0], store.cfg.value_size),
                         dtype=np.uint8)
    t0 = time.perf_counter()
    store.put_batch(r.permutation(fresh))
    store.put_batch(ow, ow_vals)
    store.delete_batch(dead)
    store.flush_all()
    write_s = time.perf_counter() - t0
    truth.keys = np.union1d(truth.keys, fresh)
    truth.ow_keys, truth.ow_vals = ow, ow_vals
    truth.dead = dead
    if store._engine_mode() != "model":
        fail("phase C: expected unlearned files after the writes")
    cb = []
    for _ in range(n_batches // 2):
        q = batch // 4
        cb.append(np.concatenate([r.choice(truth.keys, q), r.choice(ow, q),
                                  r.choice(dead, q),
                                  truth.absent(r, batch - 3 * q)]))
    big = np.concatenate([r.choice(truth.keys, 1 << 15),
                          truth.absent(r, 1 << 15)])
    # post-screen remainders <= host_answer_max: answered on the host
    small = [np.concatenate([r.choice(truth.keys, 48), truth.absent(r, 48)])
             for _ in range(4)]
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    res = run_gets(store, truth, cb, "C")

    def resolve(pb, p):
        truth.check("C replay", p, *store.resolve_get(pb))

    res["hot_syncs"] = hot.replay(
        "C", "BourbonStore.dispatch_get", store.dispatch_get, resolve,
        cb[1: 1 + SYNC_REPLAYS], lambda: store_token(store), device != "cpu",
        restack=lambda: drop_device_state(store))
    if device != "cpu":
        res["profile"] = profile_gets(store.get_batch, cb[:8])
    res["host_profile"] = host_profile(store.get_batch, cb[:8])
    # (run_gets leaves each group's first batch untimed: cb[0] re-warms)
    res["batch_65536"] = run_gets(store, truth, [cb[0], big], "C-65536")
    host0 = store.filter_host_answered
    res["host_answered"] = run_gets(store, truth, small, "C-host")
    if store.filter_host_answered == host0:
        fail("phase C: the small batches were not answered on the host")
    if any(res["host_answered"]["launches"].values()):
        fail("phase C: the host-answered batches launched kernels")
    phase_line("C", store, res, card, {"write_s": write_s})
    launches = dict(ops.launches)               # read just after phase C
    return store, launches, snapshot


# ----------------------------------------------------------------------------
# the durable sharded GET (phases D and E)
# ----------------------------------------------------------------------------

N_SHARDS = 4
SHARD_BATCH = 4096


def _sharded_cfg(device: str):
    """The shard config of benchmarks/bench_dist_recovery.py at full
    width, filters on (the default)."""
    from repro_torch.core import LSMConfig, MaintenanceConfig, StoreConfig
    from repro_torch.core.engine import EngineConfig
    return StoreConfig(mode="bourbon", granularity="level", policy="always",
                       value_size=16,
                       lsm=LSMConfig(memtable_cap=1 << 12, file_cap=1 << 13,
                                     l1_cap_records=1 << 15),
                       engine=EngineConfig(seg_cap=4096),
                       maintenance=MaintenanceConfig(auto_gc=False,
                                                     auto_checkpoint=False,
                                                     track_dead=False),
                       device=device)


def load_sharded(d: str, device: str, n_keys: int, seed: int) -> tuple:
    """Phase D's load: ``n_keys`` ar keys in a seeded random order into a
    ``ShardedStore`` of N_SHARDS range shards in directory ``d``
    (``_sharded_cfg``), in put batches of SHARD_BATCH; flushed and learned,
    then the last batch put, so that it is only in the WALs.  Returns the
    store, the sorted keys and that last batch."""
    from repro_torch.core import make_dataset
    from repro_torch.distributed import ShardedConfig, ShardedStore

    keys = make_dataset("ar", n_keys, seed=seed)
    perm = np.random.default_rng(seed + 10).permutation(keys)
    bounds = tuple(int(b) for b in np.quantile(
        keys, np.arange(1, N_SHARDS) / N_SHARDS))
    st = ShardedStore.open(d, ShardedConfig(N_SHARDS, bounds),
                           _sharded_cfg(device), mesh=None)
    flushed, tail = perm[:-SHARD_BATCH], perm[-SHARD_BATCH:]
    for off in range(0, flushed.shape[0], SHARD_BATCH):
        st.put_batch(flushed[off: off + SHARD_BATCH])
    st.flush_all()
    st.learn_all()
    st.put_batch(tail)                  # only in the WALs at the kill
    return st, keys, tail


def run_sharded_gets(st, truth: Truth, batches: list, tag: str,
                     answers: list | None = None) -> dict:
    """``run_gets`` for the sharded store: values fetched, every answer
    checked; the first batch (which builds the device state) is timed
    apart.  With ``answers``, each batch's found flags and values are
    appended to it as bytes."""
    from repro_torch.kernels import ops
    launched = dict(ops.launches)
    secs = []
    for bi, probes in enumerate(batches):
        t0 = time.perf_counter()
        found, values = st.get_batch(probes, with_values=True)
        secs.append(time.perf_counter() - t0)
        truth.check(f"{tag} batch {bi}", probes, found, values)
        if answers is not None:
            answers.append(found.tobytes() + values.tobytes())
    per = sorted(secs[1:])
    return {"gets": sum(p.shape[0] for p in batches),
            "batches": len(batches), "first_batch_s": secs[0],
            "gets_per_s": sum(p.shape[0] for p in batches[1:]) / sum(secs[1:]),
            "batch_ms_median": 1e3 * per[len(per) // 2],
            "batch_ms_max": 1e3 * per[-1],
            "launches": {k: v - launched[k] for k, v in ops.launches.items()}}


def _level_lookup_pair(sh, probes: np.ndarray):
    """One direct engine lookup in mode "level" whose filter mask the card
    probes (``fstate`` without a host mask), and the same lookup with the
    host screen's mask, as the store builds it."""
    from repro_torch.core.filters import filter_maybe_np
    from repro_torch.core.lsm import N_LEVELS
    eng = sh.engine
    state = eng.build_state(sh.tree, sh.level_models)
    fstate = eng.build_filter_state(sh.level_filters)
    live = [li for li in range(N_LEVELS) if sh.tree.levels[li]]
    fm = filter_maybe_np([sh.level_filters[li] for li in live], probes)
    fm_host = np.ones((N_LEVELS, probes.shape[0]), bool)
    for row, li in enumerate(live):
        fm_host[li] = fm[row]
    l0 = len(sh.tree.levels[0])
    dev = eng.lookup(state, probes, "level", l0_live=l0, fstate=fstate)
    host = eng.lookup(state, probes, "level", l0_live=l0, fstate=fstate,
                      fmaybe_host=fm_host)
    return dev, host, fstate


def replay_sharded(hot: HotSyncs, phase: str, st, truth: Truth,
                   batches: list, device: str) -> dict:
    """``HotSyncs.replay`` of a sharded store's ``dispatch_get`` (values
    fetched at resolve), its state token the store's state epoch."""
    def resolve(pb, p):
        truth.check(f"{phase} replay", p, *st.resolve_get(pb))

    return hot.replay(
        phase, "ShardedStore.dispatch_get",
        lambda p: st.dispatch_get(p, with_values=True), resolve, batches,
        lambda: st.state_epoch, device != "cpu",
        restack=lambda: drop_device_state(st))


def replay_level_shard(hot: HotSyncs, sh, truth: Truth, keys: np.ndarray,
                       batches: list, device: str) -> dict:
    """Phase E's two dispatch halves through ``HotSyncs.replay``: the
    shard's own ``dispatch_get`` in mode "level", and
    ``LookupEngine.lookup_async`` whose filter mask the card probes (its
    state and filter stack built before, as a dispatch finds them)."""
    on_card = device != "cpu"

    def resolve_get(pb, p):
        found, vptr = sh.resolve_get(pb)
        truth.check("E replay", p, found,
                    sh.vlog.get_batch_np(np.where(found, vptr, -1)))

    hot.replay("E", "BourbonStore.dispatch_get", sh.dispatch_get,
               resolve_get, batches, lambda: store_token(sh), on_card,
               restack=lambda: drop_device_state(sh))
    eng = sh.engine
    state = eng.build_state(sh.tree, sh.level_models)
    fstate = eng.build_filter_state(sh.level_filters)
    l0 = len(sh.tree.levels[0])

    def resolve_lookup(pl, p):
        res = pl.resolve()
        want = Truth._isin(keys, p) & ~sh.memtable.get_batch(p)[0]
        if not np.array_equal(res.found & (res.vptr >= 0), want):
            fail("phase E replay: the direct level lookup is wrong")

    hot.replay("E", "LookupEngine.lookup_async",
               lambda p: eng.lookup_async(state, p, "level", l0_live=l0,
                                          fstate=fstate),
               resolve_lookup, batches, lambda: store_token(sh), on_card)
    return hot.records["E"]


def drive_sharded(device: str, n_keys: int, seed: int, card: str,
                  n_batches: int = 32, *, hot: HotSyncs):
    """Phases D and E, on the stacked GET (``mesh=None``, whatever cards
    the machine has), their dispatch halves replayed into ``hot``.
    Returns the reopened store, the kernel launch counts of D and E, the
    shard engine's FilterState (for the stack probe's check at its second
    live shape), the temporary directory to remove, the store's Truth (for
    phases F and G) and D's batches (for phase G)."""
    import torch
    from repro_torch.distributed import ShardedStore
    from repro_torch.kernels import ops

    d = tempfile.mkdtemp(prefix="bourbon_smoke_shards_")
    try:
        t0 = time.perf_counter()
        st, keys, tail = load_sharded(d, device, n_keys, seed)
        load_s = time.perf_counter() - t0
        truth = Truth(keys, 16)
        if not all(sh.memtable for sh in st.shards):
            fail("phase D: the tail did not stay in the memtables")
        r = np.random.default_rng(seed + 11)
        batches = [np.concatenate([r.choice(keys, SHARD_BATCH // 2),
                                   truth.absent(r, SHARD_BATCH // 2)])
                   for _ in range(n_batches)]
        batches[1][:64] = tail[:64]         # WAL-only keys are present
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()                # the sharded path starts here
        res = run_sharded_gets(st, truth, batches, "D")
        del st                              # KILL: no close()
        gc.collect()
        t0 = time.perf_counter()
        st = ShardedStore.open(d, device=device, mesh=None)
        reopen_s = time.perf_counter() - t0
        stats = st.stats()
        if stats["files_learned"] != 0 or stats["level_models_recovered"] < 1:
            fail(f"phase D: reopen relearned ({stats['files_learned']} "
                 f"files, {stats['level_models_recovered']} level models "
                 "recovered)")
        res2 = run_sharded_gets(st, truth, batches, "D-reopen")
        res2["hot_syncs"] = replay_sharded(hot, "D", st, truth,
                                           batches[1: 1 + SYNC_REPLAYS],
                                           device)

        def get(p):
            return st.get_batch(p, with_values=True)

        if device != "cpu":
            res2["profile"] = profile_gets(get, batches[:8])
        res2["host_profile"] = host_profile(get, batches[:8])
        state = st.device_state()
        dev_bytes = (torch.cuda.max_memory_allocated()
                     if device != "cpu" else 0)
        print(json.dumps({
            "phase": "D", "shards": N_SHARDS, "keys": n_keys,
            "records": stats["n_records"], "load_s": load_s,
            "reopen_s": reopen_s, "first_batch_s": res["first_batch_s"],
            "reopen_first_batch_s": res2["first_batch_s"],
            "gets_per_s": res["gets_per_s"],
            "reopen_gets_per_s": res2["gets_per_s"],
            "batch_ms_median": res["batch_ms_median"],
            "reopen_batch_ms_median": res2["batch_ms_median"],
            "level_models_recovered": stats["level_models_recovered"],
            "models_recovered": stats["models_recovered"],
            "launches": res["launches"], "reopen_launches": res2["launches"],
            "hot_syncs": res2["hot_syncs"], "profile": res2.get("profile"),
            "host_profile": res2["host_profile"],
            "device_max_bytes": dev_bytes,
            "state_shapes": {k: list(v.shape) for k, v in state.items()},
            "card": card}))

        # phase E: one shard's own GET in mode "level"
        sh = st.shards[0]
        if sh._engine_mode() != "level" or any(
                sh.level_models[i] is None
                for i in range(1, len(sh.tree.levels)) if sh.tree.levels[i]):
            fail("phase E: shard 0 does not serve every level by its model")
        own = keys[st.shard_of(keys) == 0]
        lo, hi = int(own[0]), int(own[-1])
        eb = []
        for _ in range(8):
            a = r.integers(lo, hi, 4 * SHARD_BATCH, dtype=np.int64)
            a = a[~Truth._isin(keys, a)][: SHARD_BATCH // 2]
            eb.append(np.concatenate([r.choice(own, SHARD_BATCH // 2), a]))
        base0 = sh.lookups_baseline_path
        launched = dict(ops.launches)
        secs = []
        for bi, p in enumerate(eb):
            t0 = time.perf_counter()
            found, vptr = sh.get_batch(p)
            secs.append(time.perf_counter() - t0)
            truth.check(f"E batch {bi}", p, found,
                        sh.vlog.get_batch_np(np.where(found, vptr, -1)))
        if sh.lookups_baseline_path != base0:
            fail("phase E: level-mode GETs took the baseline arm")
        e_launch = {k: v - launched[k] for k, v in ops.launches.items()}
        e_syncs = replay_level_shard(hot, sh, truth, keys,
                                     eb[1: 1 + SYNC_REPLAYS], device)
        dev, host, fstate = _level_lookup_pair(sh, eb[0])
        if not (np.array_equal(dev.found, host.found)
                and np.array_equal(dev.vptr, host.vptr)):
            fail("phase E: the device filter mask changed the answers")
        in_mt = sh.memtable.get_batch(eb[0])[0]   # the engine sees the tree
        if not np.array_equal(dev.found & (dev.vptr >= 0),
                              Truth._isin(keys, eb[0]) & ~in_mt):
            fail("phase E: the direct level lookup is wrong")
        per = sorted(secs[1:])
        print(json.dumps({
            "phase": "E", "mode": sh._engine_mode(),
            "files_per_level": [len(lv) for lv in sh.tree.levels],
            "level_segments": [None if m is None else int(m.n_segments)
                               for m in sh.level_models],
            "gets_per_s": sum(p.shape[0] for p in eb[1:]) / sum(secs[1:]),
            "batch_ms_median": 1e3 * per[len(per) // 2],
            "launches": e_launch, "hot_syncs": e_syncs,
            "filter_state": list(fstate.bits.shape),
            "direct_lookup_equal": True, "card": card}))
        launches = dict(ops.launches)       # read just after phase E
        return st, launches, fstate, d, truth, batches
    except BaseException:
        shutil.rmtree(d, ignore_errors=True)
        raise


# ----------------------------------------------------------------------------
# the served GET (phase F)
# ----------------------------------------------------------------------------

F_CLIENTS = 64            # async closed-loop clients (bench_serve part A2)
F_DEPTH = 2               # requests outstanding per client
F_KEYS_PER_REQ = 32
F_ROUNDS = 36
F_WARM = 4                # untimed leading rounds per client
F_BUDGET_US = 2048.0      # coordinator budget a tick (bench_serve)
F_PUT_SHARE = 0.05        # arm 5: requests that overwrite present keys
F_PROFILE_TICKS = 8
F_REPEATS = 5             # fresh servers of each of arms 1-4, in turns
F_CHECK_SETS = 8          # dispatched probe sets kept per batch size


def served_streams(truth: Truth, seed: int, rounds: int = F_ROUNDS,
                   put_share: float = 0.0) -> list:
    """Per-client request streams drawn as bench_serve's _request_streams
    draws them (80% of a request's keys from a hot tenth of the keys, the
    rest uniform), with a quarter of the uniform keys replaced by absent
    keys so that the filter plane prunes.  With ``put_share``, that share
    of the requests are ("put", keys, values): distinct present keys and
    random values."""
    rng = np.random.default_rng(seed)
    keys = rng.permutation(truth.keys)
    kpr = F_KEYS_PER_REQ
    hot = keys[: max(keys.shape[0] // 10, kpr)]
    streams = []
    for _ in range(F_CLIENTS):
        reqs = []
        for _ in range(rounds):
            if put_share and rng.random() < put_share:
                ks = np.unique(rng.choice(keys, kpr))
                reqs.append(("put", ks, rng.integers(
                    0, 256, (ks.shape[0], truth.value_size), np.uint8)))
                continue
            n_hot = int((rng.random(kpr) < 0.8).sum())
            uni = rng.choice(keys, kpr - n_hot)
            uni[: uni.shape[0] // 4] = truth.absent(rng, uni.shape[0] // 4)
            reqs.append(np.concatenate([rng.choice(hot, n_hot), uni]))
        streams.append(reqs)
    return streams


class _Patch:
    """Replaces the store's method ``name`` with ``self.wrap(orig)`` while
    installed, and puts back what it found, so that patches nest."""

    def __init__(self, st, name: str):
        self.st, self.name = st, name

    def __enter__(self):
        self.found = self.st.__dict__.get(self.name)
        setattr(self.st, self.name, self.wrap(getattr(self.st, self.name)))
        return self

    def __exit__(self, *exc):
        if self.found is None:
            delattr(self.st, self.name)
        else:
            setattr(self.st, self.name, self.found)


class DispatchCount(_Patch):
    """Counts the store's ``dispatch_get`` calls (each one dispatched
    batch, whichever server sends it), or those of its method ``name``,
    while installed."""

    def __init__(self, st, name: str = "dispatch_get"):
        super().__init__(st, name)
        self.n = 0

    def wrap(self, orig):
        def counted(*args, **kw):
            self.n += 1
            return orig(*args, **kw)
        return counted


class DispatchCapture(_Patch):
    """Keeps, while installed, the probes of up to F_CHECK_SETS batches of
    each padded size that the store's ``_dist_dispatch`` launches (keyed
    by the power of two it pads to; a mesh of four rounds no such size
    further)."""

    def __init__(self, st):
        super().__init__(st, "_dist_dispatch")
        self.sets = {}

    def wrap(self, orig):
        from repro_torch.core.distributed import next_pow2

        def captured(probes):
            kept = self.sets.setdefault(next_pow2(max(probes.shape[0], 64)),
                                        [])
            if len(kept) < F_CHECK_SETS:
                kept.append(np.array(probes, np.int64))
            return orig(probes)
        return captured


def serve_closed_loop(srv, truth: Truth, streams: list, tag: str,
                      profile_ticks: int = 0) -> tuple:
    """bench_serve's _closed_loop_async: each client keeps up to F_DEPTH
    requests outstanding and resubmits after backpressure.  A GET's answer
    is checked against the truth as it stood when the GET was submitted
    (a PUT updates the truth at submission, the order the server applies
    it in); the checks run after the loop, so that their host time is not
    counted as the server's.  The first F_WARM rounds of each client are
    untimed.  With ``profile_ticks``, torch.profiler records that many
    ticks from the end of the warm rounds.  Returns the answers by
    (client, round) and the timing record, with the share of the timed
    wall clock spent inside ``tick()``."""
    import torch
    from repro_torch.server import ServerRequest
    rounds = len(streams[0])
    nxt = [0] * F_CLIENTS
    pending = [[] for _ in range(F_CLIENTS)]
    answers = [[None] * rounds for _ in range(F_CLIENTS)]
    lat_ticks, lat_ms, done = [], [], []
    total, warm_total = F_CLIENTS * rounds, F_CLIENTS * F_WARM
    served = rid = tick0 = keys0 = tick_s = 0
    t_start = prof = prof_out = None
    while served < total:
        if served >= warm_total and t_start is None:
            t_start, tick0 = time.perf_counter(), srv.ticks
            if profile_ticks:
                from torch.profiler import ProfilerActivity, profile
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.start()
        for c in range(F_CLIENTS):
            while len(pending[c]) < F_DEPTH and nxt[c] < rounds:
                item = streams[c][nxt[c]]
                op, ks, vals = item if isinstance(item, tuple) \
                    else ("get", item, None)
                r = ServerRequest(rid, op, ks, vals)
                if not srv.submit(r):      # backpressure: retry next tick
                    break
                r.slot = (c, nxt[c])
                r.t0 = time.perf_counter()
                if op == "put":
                    truth.overwrite(ks, vals)
                # overwrite() rebinds: this is the truth as of now
                r.version = (truth.ow_keys, truth.ow_vals)
                rid += 1
                pending[c].append(r)
                nxt[c] += 1
        t0 = time.perf_counter()
        srv.tick()
        now = time.perf_counter()
        if t_start is not None:
            tick_s += now - t0
        for c in range(F_CLIENTS):
            for r in [r for r in pending[c] if r.done]:
                pending[c].remove(r)
                done.append(r)
                if t_start is not None:
                    lat_ticks.append(r.latency_ticks)
                    lat_ms.append(1e3 * (now - r.t0))
                    keys0 += r.keys.shape[0]
                served += 1
        if prof is not None and (srv.ticks - tick0 >= profile_ticks
                                 or served >= total):
            torch.cuda.synchronize()
            prof.stop()
            prof_out = {"ticks": srv.ticks - tick0,
                        **device_summary(prof,
                                         time.perf_counter() - t_start)}
            prof = None
    dt = time.perf_counter() - t_start
    now = (truth.ow_keys, truth.ow_vals)
    for r in done:
        if r.op == "get":
            truth.ow_keys, truth.ow_vals = r.version
            truth.check(f"{tag} request {r.rid}", r.keys, r.found, r.result)
            answers[r.slot[0]][r.slot[1]] = (r.found.tobytes()
                                             + r.result.tobytes())
    truth.ow_keys, truth.ow_vals = now
    timed = len(lat_ticks)
    return answers, {"requests": timed, "seconds": dt,
                     "tick_share": tick_s / dt,
                     "requests_per_s": timed / dt, "keys_per_s": keys0 / dt,
                     "p50_ticks": float(np.percentile(lat_ticks, 50)),
                     "p99_ticks": float(np.percentile(lat_ticks, 99)),
                     "p50_ms": float(np.percentile(lat_ms, 50)),
                     "p99_ms": float(np.percentile(lat_ms, 99)),
                     "ticks": srv.ticks, "profile": prof_out}


def _reconcile_obs(tag: str, srv, st, n_gets0: int) -> dict:
    """Phase F's obs checks on a served arm: the completed counter, the
    cache counters against the served totals, the fleet's GET counter
    against the store's, and the spans of the trace export."""
    from repro_torch.obs import READ_STAGES
    snap = srv.obs.snapshot()
    s = srv.stats()

    def one(name):
        return snap[name]["samples"][0]["value"]

    if one("server_completed_total") != s["completed"]:
        fail(f"{tag}: server_completed_total {one('server_completed_total')}"
             f" != {s['completed']} requests completed")
    cs = s["cache"]
    if not (s["served_from_cache"] == cs["hits"] == one("cache_hits_total")
            == one("server_served_from_cache_total")
            and one("server_store_probe_keys_total") == s["store_probe_keys"]):
        fail(f"{tag}: the cache counters do not reconcile with the served "
             f"totals ({cs}, {s['served_from_cache']}, "
             f"{s['store_probe_keys']})")
    if one("fleet_gets_total") != st.n_gets:
        fail(f"{tag}: fleet_gets_total {one('fleet_gets_total')} != the "
             f"store's n_gets {st.n_gets}")
    if st.n_gets - n_gets0 != one("server_store_probe_keys_total"):
        fail(f"{tag}: n_gets rose by {st.n_gets - n_gets0}, not by the "
             f"{one('server_store_probe_keys_total')} keys the server "
             "probed")
    names = {e["name"] for e in srv.obs.trace_events()["traceEvents"]
             if e["ph"] == "X"}
    if not {"device_compute", "value_fetch"} <= names:
        fail(f"{tag}: the trace export lacks device_compute or value_fetch "
             f"spans ({sorted(names)})")
    stages = {dict(x["labels"])["stage"]: x["value"]
              for x in snap["server_stage_us"]["samples"]}
    return {"stage_mean_us": {k: (stages[k]["sum"] / stages[k]["count"]
                                  if stages.get(k, {}).get("count") else None)
                              for k in READ_STAGES},
            "stage_count": {k: stages.get(k, {}).get("count", 0)
                            for k in READ_STAGES},
            "traced_requests": srv.obs.ctrace.traced_requests,
            "span_names": sorted(names)}


def _serve_arm(st, truth: Truth, i: int, cls, cfg, streams: list, seed: int,
               profile: bool) -> tuple:
    """One run of phase F's arm ``i``: a fresh ``cls`` server with ``cfg``
    on ``st`` serves ``streams``; with ``profile`` (arm 3's first run, on
    the card) a second stream's first ticks after the warm rounds run under
    torch.profiler for the device's idle share.  Returns (the arm's record,
    its answers)."""
    from repro_torch.kernels import ops
    from repro_torch.server import PipelinedServer
    tag = f"F arm {i}"
    launched = dict(ops.launches)
    vf0 = dict(st.stats()["value_fetch"])
    n_gets0 = st.n_gets
    srv = cls(st, cfg)
    try:
        with DispatchCount(st) as dc:
            ans, rec = serve_closed_loop(srv, truth, streams, tag)
        s = srv.stats()
        launches = {k: v - launched[k] for k, v in ops.launches.items()}
        vf1 = st.stats()["value_fetch"]
        if profile and st.device.type == "cuda":
            # a tick answers about two rounds of every client
            prof_streams = served_streams(
                truth, seed + 22, F_WARM + 2 * F_PROFILE_TICKS + 4)
            rec["profile"] = serve_closed_loop(
                srv, truth, prof_streams, f"{tag} profile",
                profile_ticks=F_PROFILE_TICKS)[1]["profile"]
    finally:
        srv.shutdown()
    rec.update(arm=i, io_workers=cfg.io_workers, obs=cfg.obs.enabled,
               batches=s["batches"], dispatches=dc.n,
               cache_hit_rate=s["cache"]["hit_rate"], launches=launches,
               launches_per_dispatch={k: v / max(dc.n, 1)
                                      for k, v in launches.items()})
    if cls is PipelinedServer:
        p = s["pipeline"]
        rec.update(max_depth_seen=p["max_depth_seen"],
                   epoch_violations=p["epoch_violations"],
                   write_barriers=p["write_barriers"])
        if p["epoch_violations"] != 0:
            fail(f"{tag}: {p['epoch_violations']} epoch violations")
        if p["max_depth_seen"] <= 1:
            fail(f"{tag}: the pipeline never held two batches")
    hid = vf1["hidden_us"] - vf0["hidden_us"]
    exp = vf1["exposed_us"] - vf0["exposed_us"]
    rec["value_fetch_overlap"] = hid / (hid + exp) if hid + exp else 0.0
    if cfg.obs.enabled:
        rec.update(_reconcile_obs(tag, srv, st, n_gets0))
    if i == 5 and s["pipeline"]["write_barriers"] == 0:
        fail(f"{tag}: no write reached the store")
    return rec, ans


def served_arms(st) -> tuple:
    """Phase F's five server arms on ``st``, as (name, class, config), and
    the coordinator's budget a tick: bench_serve's 2048 µs, or the store's
    atomic segment collection where that is larger (the coordinator
    refuses a budget below it)."""
    from repro_torch.obs import ObsConfig
    from repro_torch.server import (BourbonServer, CoordinatorConfig,
                                    PipelineConfig, PipelinedServer,
                                    ServerConfig)
    atomic = max(sh.cfg.costs.t_gc(sh.cfg.vlog_seg_slots,
                                   sh.cfg.vlog_seg_slots) for sh in st.shards)
    budget = max(F_BUDGET_US, atomic)
    base = dict(max_batch_keys=1024, max_wait_ticks=0,
                queue_capacity=2 * F_DEPTH * F_CLIENTS,
                max_batches_per_tick=8, coordinate_maintenance=True,
                coordinator=CoordinatorConfig(budget_us_per_tick=budget))
    pipe = dict(base, max_inflight=8, carry=1)
    obs = ObsConfig(sample_every=4, trace_sample_every=64)
    off = ObsConfig(enabled=False)
    arms = [("BourbonServer", BourbonServer, ServerConfig(**base, obs=off)),
            ("PipelinedServer", PipelinedServer,
             PipelineConfig(**pipe, io_workers=0, obs=off)),
            ("PipelinedServer+io2", PipelinedServer,
             PipelineConfig(**pipe, io_workers=2, obs=off)),
            ("PipelinedServer+io2+obs", PipelinedServer,
             PipelineConfig(**pipe, io_workers=2, obs=obs)),
            ("PipelinedServer+io2+obs+puts", PipelinedServer,
             PipelineConfig(**pipe, io_workers=2, obs=obs))]
    return arms, budget


def drive_served(st, truth: Truth, seed: int, card: str) -> dict:
    """Phase F: the served GET on the reopened sharded store of phase D, in
    five arms, each a fresh server on the same store (bench_serve part A2's
    geometry): 1 ``BourbonServer``; 2 ``PipelinedServer``; 3 the same with
    an I/O pool of 2 workers; 4 as 3 with the obs plane on (stage tracer
    every 4th tick, one request in 64 traced); 5 as 4 with 5% of the
    requests PUTs of present keys.  Arms 1-4 run F_REPEATS times each, in
    turns, serve the same streams and must answer byte for byte alike;
    every answer is held to the truth.  An arm's rates and latencies are
    the medians of its runs, and the ratios of adjacent arms are taken run
    by run.  Launch counts are zeroed just before the first run and read
    just after arm 5; the probes of the dispatched batches are captured
    for :func:`served_shape_checks`.  Returns the F record (also printed as
    the phase line)."""
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    arms, budget = served_arms(st)
    streams = served_streams(truth, seed + 20)
    put_streams = served_streams(truth, seed + 21, put_share=F_PUT_SHARE)
    n_puts = sum(isinstance(x, tuple) for s in put_streams for x in s)
    runs = {i: [] for i in range(1, 6)}
    capture = DispatchCapture(st)
    ops.reset_launches()                 # the served path starts here
    with capture:
        for i in [a for _ in range(F_REPEATS) for a in (1, 2, 3, 4)] + [5]:
            _, cls, cfg = arms[i - 1]
            runs[i].append(_serve_arm(st, truth, i, cls, cfg,
                                      put_streams if i == 5 else streams,
                                      seed, profile=(i == 3 and not runs[i])))
    launches = dict(ops.launches)        # read just after arm 5
    first = runs[1][0][1]
    for i in (1, 2, 3, 4):
        for r, (_, ans) in enumerate(runs[i]):
            if ans != first:
                bad = sum(a != b for ra, rb in zip(first, ans)
                          for a, b in zip(ra, rb))
                fail(f"F: arm {i} (run {r + 1}) answered {bad} requests "
                     "differently from arm 1's first run")
    out = []
    for i in range(1, 6):
        recs = [r for r, _ in runs[i]]
        rec = dict(recs[0], server=arms[i - 1][0], repeats=len(recs))
        for key in ("requests_per_s", "keys_per_s", "p50_ms", "p99_ms",
                    "p50_ticks", "p99_ticks", "tick_share",
                    "value_fetch_overlap"):
            rec[key] = float(np.median([r[key] for r in recs]))
        rec["requests_per_s_runs"] = [r["requests_per_s"] for r in recs]
        out.append(rec)

    def ratio(a, b):
        """Arm a's rate over arm b's, run by run (each pair adjacent in
        time), with the median and the extremes."""
        xs = [ra[0]["requests_per_s"] / rb[0]["requests_per_s"]
              for ra, rb in zip(runs[a], runs[b])]
        return {"median": float(np.median(xs)), "min": min(xs),
                "max": max(xs), "runs": xs}

    ratios = {"arm2/arm1": ratio(2, 1), "arm3/arm2": ratio(3, 2),
              "arm4/arm3": ratio(4, 3)}
    rec = {"phase": "F", "clients": F_CLIENTS, "depth": F_DEPTH,
           "keys_per_request": F_KEYS_PER_REQ, "rounds": F_ROUNDS,
           "warm_rounds": F_WARM, "repeats_arms_1_4": F_REPEATS,
           "coordinator_budget_us": budget, "puts_arm5": n_puts,
           "arms": out, "ratios": ratios,
           "obs_overhead": ratios["arm4/arm3"]["median"],
           "identical_arms_1_4": True, "launches": launches,
           "served_shape_checks": served_shape_checks(st, capture.sets),
           "seconds": time.perf_counter() - t_phase, "card": card}
    print(json.dumps(rec))
    return rec


def served_shape_checks(st, sets: dict) -> dict:
    """The three kernels of the served path against their plain versions on
    probes phase F dispatched (``DispatchCapture.sets``), padded and routed
    as ``_dist_dispatch`` pads and routes them, on the sharded state as it
    stands after F: the batch sizes the server sends, which the checks at
    CHECK_B do not cover.  Per kernel: the batch sizes, the sets, the
    outputs that differ and the largest difference."""
    import torch
    from repro_torch.core.store import _PAD_PROBE
    state = st.device_state()
    dev = state["keys"].device
    padded = []
    for B, kept in sorted(sets.items()):
        for probes in kept:
            buf = np.full(B, _PAD_PROBE, np.int64)
            buf[: probes.shape[0]] = probes
            padded.append((torch.from_numpy(st.shard_of(buf)).to(dev),
                           torch.from_numpy(buf).to(dev)))
    out = _compare_sets(state, st.shards[0].cfg.lsm.bloom_k, st.delta,
                        padded)
    for rec in out.values():
        rec["B"] = sorted(sets)
    return out


# ----------------------------------------------------------------------------
# the mesh GET (phase G)
# ----------------------------------------------------------------------------

G_ARMS = (1, 2)           # phase F's arms served once each over the mesh
G_EXAMPLE_BATCHES = 8     # GETs of port/examples/distributed_get.py
MESH_KERNELS = ("bloom_probe_stack", "plr_lookup", "bounded_search")


def _example():
    """``port/examples/distributed_get.py`` as a module."""
    import importlib.util
    path = os.path.join(HERE, "port", "examples", "distributed_get.py")
    spec = importlib.util.spec_from_file_location("distributed_get", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def drive_mesh(st, path: str, truth: Truth, batches: list, n_keys: int,
               seed: int, device: str, card: str, *, hot: HotSyncs):
    """Phase G: the mesh GET, its dispatch half replayed into ``hot``.
    D's batches run once more on D's store without a mesh, as it stands
    after F; the store is closed and reopened from its directory on a
    mesh of one device a shard (four distinct cards when the machine has
    four, else ``device`` four times); the batches replay, every answer
    checked against the truth and byte for byte against the answers
    without a mesh; F's arms 1-2 serve once each over the mesh store,
    answering alike; and ``port/examples/distributed_get.py`` runs at
    ``n_keys`` keys over every visible card.  Counts are zeroed just
    before G and read just after: each of the three kernels must launch
    once a mesh device a mesh GET (the example's filterless state runs no
    stack probe).
    Returns the mesh store, the G record (also printed) and the probe sets
    for :func:`mesh_shape_checks`: the batches the mesh store dispatched
    (``DispatchCapture.sets``) and the example's keys, δ and state."""
    import torch
    from repro_torch.core.mesh import make_mesh
    from repro_torch.distributed import ShardedStore
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    plain = []
    run_sharded_gets(st, truth, batches, "G without a mesh", plain)
    st.close()
    distinct = (device != "cpu"
                and torch.cuda.device_count() >= N_SHARDS)
    one = "cpu" if device == "cpu" else "cuda:0"
    mesh = make_mesh((N_SHARDS,), ("shard",),
                     None if distinct else [one] * N_SHARDS)
    ex_mesh = (make_mesh((torch.cuda.device_count(),), ("data",))
               if device != "cpu" else make_mesh((1,), ("data",), ["cpu"]))
    streams = served_streams(truth, seed + 20)
    ops.reset_launches()                 # the mesh path starts here
    t0 = time.perf_counter()
    stm = ShardedStore.open(path, device=device, mesh=mesh)
    reopen_s = time.perf_counter() - t0
    if not stm.uses_shard_map:
        fail("phase G: the store did not take its mesh")
    arms, _ = served_arms(stm)
    with (DispatchCapture(stm) as capture,
          DispatchCount(stm, "_dist_dispatch") as dc):
        answers = []
        res = run_sharded_gets(stm, truth, batches, "G", answers)
        if answers != plain:
            bad = sum(a != b for a, b in zip(answers, plain))
            fail(f"phase G: {bad} batches answered differently from the "
                 "same store without a mesh")
        hot_syncs = replay_sharded(hot, "G", stm, truth,
                                   batches[1: 1 + SYNC_REPLAYS], device)

        def get(p):
            return stm.get_batch(p, with_values=True)

        if device != "cpu":
            res["profile"] = profile_gets(get, batches[:8])
        served = []
        for i in G_ARMS:
            name, cls, cfg = arms[i - 1]
            rec, ans = _serve_arm(stm, truth, i, cls, cfg, streams, seed,
                                  profile=False)
            served.append((rec, ans))
        if any(ans != served[0][1] for _, ans in served):
            fail("phase G: the served arms answered differently")
    t0 = time.perf_counter()
    example = _example()
    ex_keys, ex_cfg, ex_state = example.build(ex_mesh, n_keys)
    ex = example.run(ex_mesh, ex_keys, ex_cfg, ex_state, G_EXAMPLE_BATCHES,
                     seed)
    ex["total_s"] = time.perf_counter() - t0
    if device != "cpu":
        torch.cuda.synchronize()
    launches = dict(ops.launches)        # read just after phase G
    expect = {name: mesh.size * dc.n for name in MESH_KERNELS}
    for name in ("plr_lookup", "bounded_search"):
        expect[name] += ex_mesh.size * G_EXAMPLE_BATCHES
    if device != "cpu":
        for name in MESH_KERNELS:
            if launches[name] != expect[name]:
                fail(f"phase G: {name} launched {launches[name]} times, "
                     f"not {expect[name]} (once a mesh device a GET)")
    rec = {"phase": "G",
           "mesh": {"size": mesh.size, "distinct_cards": distinct,
                    "devices": [str(d) for d in mesh.devices]},
           "reopen_s": reopen_s, "first_batch_s": res["first_batch_s"],
           "gets_per_s": res["gets_per_s"],
           "batch_ms_median": res["batch_ms_median"],
           "batch_ms_max": res["batch_ms_max"],
           "identical_to_no_mesh": True, "mesh_gets": dc.n,
           "hot_syncs": hot_syncs,
           "profile": res.get("profile"),
           "arms": [{k: r[k] for k in ("arm", "requests_per_s",
                                       "keys_per_s", "p50_ms", "p99_ms",
                                       "dispatches", "launches_per_dispatch",
                                       "cache_hit_rate")}
                    for r, _ in served],
           "distributed_get": {**ex, "mesh": [str(d)
                                              for d in ex_mesh.devices]},
           "launches": launches, "expected_launches": expect,
           "seconds": time.perf_counter() - t_phase, "card": card}
    print(json.dumps(rec))
    return stm, rec, {"dispatched": capture.sets,
                      "example": (ex_keys, ex_cfg.delta, ex_state[0])}


def _mesh_pad(p: np.ndarray, size: int, dev):
    """``p`` padded as the mesh GET pads a batch over ``size`` devices, on
    ``dev``, with the one-row ``rows`` every mesh device runs."""
    import torch
    from repro_torch.core.distributed import next_pow2
    from repro_torch.core.store import _PAD_PROBE
    B = -(-next_pow2(max(p.shape[0], 64)) // size) * size
    buf = np.full(B, _PAD_PROBE, np.int64)
    buf[: p.shape[0]] = p
    return (torch.zeros(B, dtype=torch.int32, device=dev),
            torch.from_numpy(buf).to(dev))


def _compare_sets(state: dict, k: int, delta: int, padded: list,
                  names=MESH_KERNELS) -> dict:
    """The kernels ``names`` (of the three the sharded GET runs) against
    their plain versions on the device state ``state`` (stacked, or one
    mesh row) over the (rows, probes) sets ``padded``.  ``bounded_search``
    gets the plain positions, so that its check stands alone.  Per kernel:
    the sets, the outputs that differ and the largest difference."""
    from repro_torch.kernels import ops, ref
    tables = (state["starts"], state["slopes"], state["icepts"],
              state["nseg"], state["n"])
    out = {name: {"sets": 0, "mismatches": 0, "max_abs_err": 0.0}
           for name in names}
    for rows, p in padded:
        pos = ref.plr_lookup_rows_ref(*tables, rows, p)
        pairs = {
            "plr_lookup": lambda: (ops.plr_lookup(*tables, rows, p), pos),
            "bounded_search": lambda: (
                ops.bounded_search(state["keys"], state["n"], rows, pos, p,
                                   delta),
                ref.bounded_search_rows_ref(state["keys"], state["n"], rows,
                                            pos, p, delta)),
            "bloom_probe_stack": lambda: (
                ops.bloom_probe_stack(state["fbits"], state["fnw"], p, k),
                ref.bloom_probe_stack_ref(state["fbits"], state["fnw"], p,
                                          k))}
        for name in names:
            got, want = pairs[name]()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            rec = out[name]
            rec["sets"] += 1
            for g, w in zip(got, want):
                d = (g.long() - w.long()).abs()
                rec["mismatches"] += int((d != 0).sum())
                rec["max_abs_err"] = max(rec["max_abs_err"], float(d.max()))
    return out


def _merge(into: dict, part: dict) -> None:
    for name, rec in part.items():
        got = into.setdefault(name, {"sets": 0, "mismatches": 0,
                                     "max_abs_err": 0.0})
        got["sets"] += rec["sets"]
        got["mismatches"] += rec["mismatches"]
        got["max_abs_err"] = max(got["max_abs_err"], rec["max_abs_err"])


def mesh_shape_checks(stm, batches: list, sets: dict, seed: int) -> dict:
    """The three kernels of the mesh GET against their plain versions at
    every one-row shape phase G ran them at, on every mesh device's own
    shard row (the filter row (1, W), the row's segment table (1, S) and
    keys (1, C); every device sees the whole padded batch):

    - ``mesh_shape``: TIMED_BATCHES probe sets made of D's batches, timed
      on mesh device 0's row;
    - ``mesh_dispatched_shape``: the batches the mesh store dispatched in
      G (``sets["dispatched"]``, 64-4096 probes, arms 1-2 included);
    - ``mesh_example_shape``: ``plr_lookup`` and ``bounded_search`` on row
      0 of the example's filterless state (``sets["example"]``, one row of
      ``--shard-keys`` keys on one card), over G_EXAMPLE_BATCHES sets of
      4096 probes, half of them absent keys, with the keys beyond both
      ends and the pad probe among them.

    Returns {tag: {kernel: record}}."""
    from repro_torch.core.store import _PAD_PROBE
    from repro_torch.kernels import ops, ref
    state = stm.device_state()
    mesh = stm._mesh
    k = stm.shards[0].cfg.lsm.bloom_k
    timed, dispatched = {}, {}
    for s, (row, dev) in enumerate(zip(state, mesh.devices)):
        padded = [_mesh_pad(batches[i % len(batches)], mesh.size, dev)
                  for i in range(TIMED_BATCHES)]
        if s == 0:
            tables = (row["starts"], row["slopes"], row["icepts"],
                      row["nseg"], row["n"])
            probes = [p for _, p in padded]
            trips = [(r, p, ref.plr_lookup_rows_ref(*tables, r, p))
                     for r, p in padded]
            fns = {
                "bloom_probe_stack": (
                    lambda i: ops.bloom_probe_stack(row["fbits"], row["fnw"],
                                                    probes[i], k),
                    lambda i: ref.bloom_probe_stack_ref(
                        row["fbits"], row["fnw"], probes[i], k),
                    _stack_work(row["fbits"], row["fnw"], probes, k)),
                "plr_lookup": (*_plr_fns(tables, trips),
                               _plr_work(tables, trips)),
                "bounded_search": (
                    lambda i: ops.bounded_search(
                        row["keys"], row["n"], trips[i][0], trips[i][2],
                        trips[i][1], stm.delta),
                    lambda i: ref.bounded_search_rows_ref(
                        row["keys"], row["n"], trips[i][0], trips[i][2],
                        trips[i][1], stm.delta),
                    _bounded_work(row["keys"], trips, stm.delta)),
            }
            for name, (kern, plain, work) in fns.items():
                timed[name] = {
                    **_measure(kern, plain, work, _symbol(name)),
                    "rows": mesh.size, "sets": TIMED_BATCHES,
                    "shape": {"L": 1, "W": row["fbits"].shape[1],
                              "S": row["starts"].shape[1],
                              "C": row["keys"].shape[1],
                              "B": probes[0].shape[0]}}
        else:
            _merge(timed, _compare_sets(row, k, stm.delta, padded))
        _merge(dispatched, _compare_sets(
            row, k, stm.delta,
            [_mesh_pad(p, mesh.size, dev)
             for kept in sets["dispatched"].values() for p in kept]))
    for rec in dispatched.values():
        rec["B"] = sorted(sets["dispatched"])
    ex_keys, ex_delta, ex_row = sets["example"]
    dev = ex_row["keys"].device
    rng = np.random.default_rng(seed + 30)
    edges = np.array([ex_keys[0] - 1, ex_keys[-1] + 1, _PAD_PROBE], np.int64)
    ex_sets = []
    for _ in range(G_EXAMPLE_BATCHES):
        p = np.concatenate([rng.choice(ex_keys, 2048),
                            Truth(ex_keys, 0).absent(rng, 2048 - 3), edges])
        ex_sets.append(_mesh_pad(rng.permutation(p), 1, dev))
    example = _compare_sets(ex_row, k, ex_delta, ex_sets,
                           ("plr_lookup", "bounded_search"))
    for rec in example.values():
        rec["shape"] = {"S": ex_row["starts"].shape[1],
                        "C": ex_row["keys"].shape[1], "B": 4096,
                        "absent_share": 0.5}
    return {"mesh_shape": timed, "mesh_dispatched_shape": dispatched,
            "mesh_example_shape": example}


# ----------------------------------------------------------------------------
# kernels against their plain versions
# ----------------------------------------------------------------------------

# ----------------------------------------------------------------------------
# the served LM over the session index (phase H)
# ----------------------------------------------------------------------------

H_ARCH = "qwen2-0.5b"     # the arch of launch/serve.py and the serving test
H_SESSIONS = 1 << 20      # live background sessions preloaded in the index
H_REG_BATCH = 4096        # sessions a register_batch
H_EVICT = 410             # of each register batch, evicted a batch later
H_REQUESTS = 256
H_MAX_NEW = 16
H_BG_EVERY = 8            # engine steps between background register batches
H_DIRECT = 32             # direct lookup_batch calls of H_REG_BATCH ids
H_PROFILE_AT = 2          # first profiled engine step (no admission in it)
H_PROFILE_STEPS = 8
H_ENGINE = {"max_batch": 256, "max_seq": 1024, "page_tokens": 16,
            "n_pages": 4096}
H_CHECK_B, H_CHECK_T, H_CPU_STEPS = 8, 16, 4
# Set from readings on an H100 (port/scripts/logit_tol_control.py, seeds
# 0-3): the sound port reads 1.69-2.11% of the largest logit for both
# comparisons.  Controls with the norm or RoPE in bf16 read 1.75-2.27%,
# and with the softmax in bf16 or the score divide after the f32 cast
# exactly as sound (the scores are bf16 already; sqrt(64) is exact).  With
# random weights those faults move the logits less than bf16's own
# roundings do, so no bound above the sound readings sees them; 2^-4 is
# 2.75x the largest reading.
H_LOGIT_TOL = 2.0 ** -4


class SessionTruth:
    """The session index behind a ground-truth dict: ids registered minus
    ids evicted -> (first_page, n_pages, prefix_len).  Stands in for the
    engine's ``SessionStore``: registers and evictions go through to the
    store and update the dict, and every lookup's answer is checked against
    it (a miss fails the run, naming ``phase``).  Keeps up to TIMED_BATCHES
    of the id batches the engine looked up, for the kernel checks."""

    def __init__(self, inner):
        self.inner, self.phase = inner, "H"
        self.live = {}
        self.lookups = self.ids_checked = 0
        self.engine_sets = []

    @property
    def store(self):
        return self.inner.store

    def register_batch(self, ids, recs) -> None:
        self.inner.register_batch(ids, recs)
        for i, r in zip(ids.tolist(), recs):
            self.live[i] = (r.first_page, r.n_pages, r.prefix_len)

    def evict_batch(self, ids) -> None:
        self.inner.evict_batch(ids)
        for i in ids.tolist():
            self.live.pop(i, None)

    def lookup_batch(self, ids):
        found, recs = self.inner.lookup_batch(ids)
        self.check(f"{self.phase} engine lookup", ids, found, recs)
        if len(self.engine_sets) < TIMED_BATCHES:
            self.engine_sets.append(np.array(ids, np.int64))
        return found, recs

    def check(self, tag: str, ids, found, recs) -> None:
        for j, i in enumerate(ids.tolist()):
            got = (None if not found[j] else
                   (recs[j].first_page, recs[j].n_pages, recs[j].prefix_len))
            if got != self.live.get(i):
                fail(f"{tag} {self.lookups}: session {i} read {got}, "
                     f"expected {self.live.get(i)}")
        self.lookups += 1
        self.ids_checked += len(ids)

    def stats(self) -> dict:
        return self.inner.stats()


def _records(ids, b: int):
    from repro_torch.serving.session_store import PageRecord
    return [PageRecord(i & 0xFFFFF, 1 + b % 64, j % 1024)
            for j, i in enumerate(ids.tolist())]


def _float_copy(tree):
    """A parameter tree as float32 on the CPU."""
    if isinstance(tree, dict):
        return {k: _float_copy(v) for k, v in tree.items()}
    return tree.detach().float().cpu()


def lm_logit_readings(params, cfg, seed: int, device: str) -> dict:
    """At the served model's width: the decode of H_CHECK_B sequences of
    H_CHECK_T tokens, step by step, against ``forward`` over the same
    tokens, and its first H_CPU_STEPS steps against the same port in f32 on
    the CPU from the same parameters: each comparison's largest error and
    the reference's largest logit."""
    import torch
    from repro_torch.models import (Model, decode_step, forward,
                                    init_caches)

    toks = torch.from_numpy(np.random.default_rng(seed + 11).integers(
        0, cfg.vocab, (H_CHECK_B, H_CHECK_T)).astype(np.int32))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with torch.inference_mode():
        full = forward(params, cfg, tokens=toks.to(device))[0].float()
        caches = init_caches(cfg, H_CHECK_B, H_CHECK_T, device=device)
        dec = torch.cat([decode_step(params, cfg, caches,
                                     tokens=toks[:, i:i + 1].to(device))[0]
                         for i in range(H_CHECK_T)], dim=1).float()
        p32 = Model(cfg32, _float_copy(params.tree()))
        c32 = init_caches(cfg32, H_CHECK_B, H_CHECK_T, device="cpu")
        cpu = torch.cat([decode_step(p32, cfg32, c32,
                                     tokens=toks[:, i:i + 1])[0]
                         for i in range(H_CPU_STEPS)], dim=1)
    out = {}
    for tag, got, want in (("decode_vs_forward", dec, full),
                           ("card_vs_cpu_f32", dec[:, :H_CPU_STEPS].cpu(),
                            cpu)):
        out[tag] = {"max_abs_err": float((got.cpu() - want.cpu()).abs().max()),
                    "logit_scale": float(want.abs().max()),
                    "finite": bool(torch.isfinite(got).all())}
    return out


def lm_logit_checks(params, cfg, seed: int, device: str) -> dict:
    """:func:`lm_logit_readings`, each comparison within H_LOGIT_TOL of the
    reference's largest logit."""
    out = lm_logit_readings(params, cfg, seed, device)
    for tag, r in out.items():
        r["tol"] = H_LOGIT_TOL * r["logit_scale"]
        if not r["finite"] or r["max_abs_err"] > r["tol"]:
            fail(f"phase H: {tag} logits differ by {r['max_abs_err']} "
                 f"(tolerance {r['tol']})")
    out["shape"] = {"B": H_CHECK_B, "T": H_CHECK_T,
                    "cpu_steps": H_CPU_STEPS}
    return out


def serve_requests(eng, truth: SessionTruth, reqs: list, batches, b0: int,
                   tag: str) -> dict:
    """Serves ``reqs`` through ``eng`` until drained, registering the next
    id batch of ``batches`` (records numbered from ``b0``) as background
    sessions every H_BG_EVERY engine steps (flushing the active sessions
    out of the memtable, as other engines sharing the index would), with
    H_PROFILE_STEPS loop turns from engine step H_PROFILE_AT under
    torch.profiler on the card.  Launch counts are zeroed just before the
    serving loop.  Every request must finish with H_MAX_NEW tokens of the
    vocabulary and every page return to the pool."""
    import torch
    from repro_torch.kernels import ops

    on_card = eng.device.type == "cuda"
    for r in reqs:
        eng.submit(r)
    n_bg = 0

    def serve_step() -> bool:
        """One turn of the serving loop: a background register batch every
        H_BG_EVERY engine steps, then an engine step; False once
        drained."""
        nonlocal n_bg
        if not (eng.queue or eng.active):
            return False
        if eng.steps and eng.steps % H_BG_EVERY == 0:
            ids = next(batches)
            truth.register_batch(ids, _records(ids, b0 + n_bg))
            n_bg += 1
        eng.step()
        return True

    profile = None
    lookups0 = truth.lookups
    if on_card:
        torch.cuda.synchronize()
    ops.reset_launches()                      # the main path starts here
    t0 = time.perf_counter()
    while eng.queue or eng.active:
        if on_card and eng.steps == H_PROFILE_AT:
            profile = profile_steps(serve_step, H_PROFILE_STEPS)
            profile["first_step"] = H_PROFILE_AT
        else:
            serve_step()
    serve_s = time.perf_counter() - t0

    vocab, n_pages = eng.cfg.vocab, eng.ecfg.n_pages
    for r in reqs:
        if not r.done or len(r.generated) != H_MAX_NEW:
            fail(f"phase {tag}: request {r.rid} done={r.done} with "
                 f"{len(r.generated)} tokens")
        if not all(0 <= t < vocab for t in r.generated):
            fail(f"phase {tag}: request {r.rid} generated a token outside "
                 f"the vocabulary")
    if sorted(eng.pool.free) != list(range(n_pages)):
        fail(f"phase {tag}: pages missing from the pool after draining")
    prefill = sum(int(r.prompt.shape[0]) for r in reqs)
    generated = sum(len(r.generated) for r in reqs)
    return {"requests": len(reqs), "max_new": H_MAX_NEW,
            "prefill_steps": prefill, "engine_steps": eng.steps,
            "generated_tokens": generated, "serve_s": serve_s,
            "generated_tokens_per_s": generated / serve_s,
            "engine_steps_per_s": eng.steps / serve_s,
            "decode_steps_per_s": (prefill + eng.steps) / serve_s,
            "background_batches_while_serving": n_bg,
            "engine_lookups": truth.lookups - lookups0, "profile": profile}


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(t) for t in tree.values())
    return tree.numel() * tree.element_size()


def _model_bytes(params, eng) -> dict:
    """Parameter and cache bytes; for a ``hybrid`` stack the cache split
    into its attention ring and its Mamba state."""
    out = {"param_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters()),
           "cache_bytes": _tree_bytes(eng.caches)}
    hybrid = [c for c in eng.caches.values() if "mamba" in c]
    if hybrid:
        out["cache_bytes_attn"] = sum(_tree_bytes(c["attn"]) for c in hybrid)
        out["cache_bytes_ssm"] = sum(_tree_bytes(c["mamba"]) for c in hybrid)
    return out


def drive_lm(device: str, seed: int, card: str, n_sessions: int = H_SESSIONS,
             n_requests: int = H_REQUESTS, arch_cfg=None,
             ecfg: dict | None = None) -> tuple:
    """Phase H: the served LM.  ``arch_cfg`` (default: H_ARCH at full width
    in bf16) from ``init_params`` with a generator seeded ``seed`` serves
    ``n_requests`` requests through ``ServingEngine`` (``ecfg``, default
    H_ENGINE) over a session index preloaded with ``n_sessions`` live
    background sessions; then H_DIRECT direct lookups.  Counts are zeroed
    just before the serving and read after the direct lookups.  Returns
    the H record (also printed), the launch counts, the session index
    (its ``SessionTruth``), the probe sets for
    :func:`session_shape_checks`, and the background id batches left with
    the number of the next."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

    on_card = device != "cpu"
    cfg = arch_cfg or get_config(H_ARCH)
    ecfg = EngineConfig(**(ecfg or H_ENGINE))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device=device)
    eng = ServingEngine(cfg, params, ecfg, session_policy="always",
                        device=device)
    truth = SessionTruth(eng.sessions)
    eng.sessions = truth
    n_batches = -(-n_sessions // (H_REG_BATCH - H_EVICT))
    rng = np.random.default_rng(seed + 7)
    pool = np.unique(rng.integers(np.iinfo(np.int64).min,
                                  np.iinfo(np.int64).max,
                                  (n_batches + 16) * H_REG_BATCH + n_requests
                                  + H_DIRECT * H_REG_BATCH, dtype=np.int64))
    pool = rng.permutation(pool)
    rids, pool = pool[:n_requests], pool[n_requests:]
    absent, pool = pool[:H_DIRECT * H_REG_BATCH // 2], \
        pool[H_DIRECT * H_REG_BATCH // 2:]
    batches = iter(np.split(pool[:(pool.shape[0] // H_REG_BATCH)
                                 * H_REG_BATCH],
                            pool.shape[0] // H_REG_BATCH))

    t0 = time.perf_counter()
    prev = None
    for b in range(n_batches):
        ids = next(batches)
        truth.register_batch(ids, _records(ids, b))
        if prev is not None:
            truth.evict_batch(rng.choice(prev, H_EVICT, replace=False))
        prev = ids
    preload_s = time.perf_counter() - t0
    n_live0 = len(truth.live)
    if n_live0 < n_sessions:
        fail(f"phase H: {n_live0} live sessions after the preload")

    prng = np.random.default_rng(seed)
    reqs = [Request(rid=int(rids[i]),
                    prompt=prng.integers(0, cfg.vocab,
                                         size=prng.integers(3, 10)
                                         ).astype(np.int32),
                    max_new=H_MAX_NEW) for i in range(n_requests)]
    served = serve_requests(eng, truth, reqs, batches, n_batches, "H")

    live = np.fromiter(truth.live.keys(), np.int64, len(truth.live))
    direct, secs = [], []
    for d in range(H_DIRECT):
        q = np.concatenate([rng.choice(live, H_REG_BATCH // 2),
                            absent[d * H_REG_BATCH // 2:
                                   (d + 1) * H_REG_BATCH // 2]])
        t1 = time.perf_counter()
        found, recs = truth.inner.lookup_batch(q)
        secs.append(time.perf_counter() - t1)
        truth.check("H direct lookup", q, found, recs)
        direct.append(q)
    launches = dict(ops.launches)             # read just after the lookups

    if truth.store.n_gets == 0:
        fail("phase H: the session store served no lookups")
    checks = lm_logit_checks(params, cfg, seed, device)
    st = truth.stats()
    n_bg = served["background_batches_while_serving"]
    rec = {"phase": "H", "arch": cfg.name, "dtype": cfg.dtype,
           "params": cfg.param_count(), **_model_bytes(params, eng),
           "engine": dataclasses.asdict(ecfg),
           "device_max_bytes": (torch.cuda.max_memory_allocated()
                                if on_card else 0),
           **served,
           "preload_s": preload_s, "preload_batches": n_batches,
           "sessions_live_after_preload": n_live0,
           "sessions_evicted_in_preload": (n_batches - 1) * H_EVICT,
           "direct_lookups": H_DIRECT, "direct_batch": H_REG_BATCH,
           "session_lookups_per_s": H_DIRECT * H_REG_BATCH / sum(secs),
           "direct_batch_ms_median": 1e3 * sorted(secs)[len(secs) // 2],
           "ids_checked": truth.ids_checked,
           "model_path_frac": st["model_path_frac"],
           "filter_host_answered": st["filter_host_answered"],
           "files_per_level": [len(lvl) for lvl in truth.store.tree.levels],
           "learned_per_level": [sum(t.model is not None for t in lvl)
                                 for lvl in truth.store.tree.levels],
           "launches": launches, "logit_checks": checks, "card": card}
    print(json.dumps(rec))
    return (rec, launches, truth, direct + truth.engine_sets,
            (batches, n_batches + n_bg))


# ----------------------------------------------------------------------------
# the MoE / MLA model served over the same session index (phase I)
# ----------------------------------------------------------------------------

I_ARCH = "deepseek-v2-lite-16b"   # MLA + MoE; fits one card at full depth
I_REQUESTS = 256
# phase I's depth: the dense prologue and 6 of the 26 MoE layers, and
# phase J's: 8 of hymba's 32 layers (cut so that the whole script stays
# inside its 1200 s on a slow host: at full depth their serving took
# 202 and 226 s of a 1266 s run on an H100 machine whose host ran slow)
I_SERVE_UNITS, J_SERVE_UNITS = 6, 8
# I2's cut depths: deepseek 3 layers (the dense prologue and two MoE
# layers), mixtral 1, llama-3.2-vision 5 (four self- and one
# cross-attention layer)
I_UNITS = {"deepseek-v2-lite-16b": 2, "mixtral-8x22b": 1,
           "llama-3.2-vision-11b": 1}
I_GATE = 0.5            # cross-attention gates (0 at init: the identity)
I_CHECK_B, I_CHECK_S, I_CHECK_STEPS = 4, 8, 4
I_MLA_T = 32            # mla_decode steps against mla_attention
# Set from readings on an H100 (seed 0; f32 matmuls run without TF32, so
# what differs is the order of the sums): the card's f32 against the CPU's
# read 1.5e-6 (deepseek decode) to 4.1e-6 (llama-3.2-vision forward) of
# the largest logit, and mla_decode against mla_attention 4.5e-7 of its
# largest output.  2^-15 is 7.4x the largest of the six card/CPU readings,
# 2^-18 8.5x the MLA one.
I_F32_TOL = 2.0 ** -15  # of the largest logit: card f32 vs CPU f32
I_MLA_TOL = 2.0 ** -18  # of the largest output: mla_decode vs mla_attention


class DropCount:
    """While installed on a ``ServingEngine``: per decode call, each MoE
    layer's keep mask (``moe.route``'s, held as it is: no device op and no
    host read in the serving loop; reduced by ``summary`` after it), and
    which rows carried a real token — the slot being prefilled while the
    engine admits, else the active slots; every other row decodes token 0,
    as in the reference's prefill."""

    def __init__(self, top_k: int):
        self.K = top_k
        self.cur, self.calls = [], []
        self.admitting = False

    def on(self, eng):
        """This counter, to be installed on ``eng`` (``drive_model``'s
        ``watch``)."""
        self.eng = eng
        return self

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.route = moe, moe.route
        eng = self.eng
        admit, decode = eng._admit, eng._decode

        def route(xg, router, K, C):
            out = self.route(xg, router, K, C)
            self.cur.append(out[3])
            return out

        def admit_():
            self.admitting = True
            try:
                admit()
            finally:
                self.admitting = False

        def decode_(tok):
            logits = decode(tok)
            rows = (eng._slot_rid.index(next(reversed(eng.active)))
                    if self.admitting else tuple(eng._slot_rid))
            self.calls.append((rows, self.cur))
            self.cur = []
            return logits

        moe.route, eng._admit, eng._decode = route, admit_, decode_
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route
        del self.eng._admit, self.eng._decode

    def summary(self, n_prefill: int) -> dict:
        """Dropped shares: of every assignment, of the real tokens' (the
        first ``n_prefill`` calls are the prefill's), and the real tokens
        that lost at least one assignment in some layer."""
        import torch
        kept = torch.stack([torch.stack(k) for _, k in self.calls])
        N, L = kept.shape[:2]                         # (N, L, G, tg*K)
        kept = kept.reshape(N, L, -1, self.K).sum(dim=-1).cpu()  # (N, L, B)
        B = kept.shape[2]
        real = torch.zeros(N, B, dtype=torch.bool)
        for i, (rows, _) in enumerate(self.calls):
            real[i, ([rows] if isinstance(rows, int) else
                     [s for s, r in enumerate(rows) if r is not None])] = True
        dropped = self.K - kept
        out = {"decode_calls": N, "moe_layers": L, "rows": B,
               "top_k": self.K, "dropped": int(dropped.sum()),
               "drop_share": float(dropped.sum()) / (N * L * B * self.K)}
        for tag, sl in (("real", slice(None)), ("prefill", slice(0, n_prefill)),
                        ("decode", slice(n_prefill, None))):
            r = real[sl]
            d = dropped[sl].permute(0, 2, 1)[r]                # (n, L)
            n = int(r.sum())
            out[f"{tag}_tokens"] = n
            out[f"{tag}_drop_share"] = (float(d.sum()) / (n * L * self.K)
                                        if n else None)
            out[f"{tag}_tokens_with_a_drop"] = int((d.sum(1) > 0).sum())
        return out


def drive_model(truth: SessionTruth, left: tuple, seed: int, card: str,
                device: str, cfg, ecfg: dict | None = None,
                n_requests: int = I_REQUESTS, tag: str = "I",
                watch=None) -> tuple:
    """Phases I1 and J (``tag``): ``cfg`` from ``init_params`` with a
    generator seeded ``seed`` serves ``n_requests`` requests through
    ``ServingEngine`` (``ecfg``, default H_ENGINE) over phase H's session
    index ``truth``, registering H's ``left`` background batches (the
    iterator advances, so a later phase registers the ones after).
    ``watch(engine)``, if given, is a context manager held around the
    serving.  Counts are zeroed just before the serving and read just
    after.  Returns the record, the launch counts and the id batches the
    engine looked up."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

    on_card = device != "cpu"
    ecfg = EngineConfig(**(ecfg or H_ENGINE))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                         device=device)
    if on_card:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ServingEngine(cfg, params, ecfg, session_policy="always",
                        device=device)
    eng.sessions = truth                      # phase H's index
    truth.phase, truth.engine_sets = tag, []
    ids_checked0, live0 = truth.ids_checked, len(truth.live)
    prng = np.random.default_rng(seed + 13)
    rids = np.unique(prng.integers(np.iinfo(np.int64).min,
                                   np.iinfo(np.int64).max, 2 * n_requests,
                                   dtype=np.int64))
    rids = prng.permutation(rids[[int(i) not in truth.live
                                  for i in rids.tolist()]])[:n_requests]
    reqs = [Request(rid=int(rids[i]),
                    prompt=prng.integers(0, cfg.vocab,
                                         size=prng.integers(3, 10)
                                         ).astype(np.int32),
                    max_new=H_MAX_NEW) for i in range(n_requests)]
    with (watch(eng) if watch else contextlib.nullcontext()):
        served = serve_requests(eng, truth, reqs, *left, tag)
    launches = dict(ops.launches)             # read just after the serving
    st = truth.stats()
    rec = {"phase": tag, "arch": cfg.name, "dtype": cfg.dtype,
           "layers": cfg.n_layers, "params": cfg.param_count(),
           "active_params": cfg.active_param_count(),
           **_model_bytes(params, eng), "init_s": init_s,
           "engine": dataclasses.asdict(ecfg),
           "device_max_bytes": (torch.cuda.max_memory_allocated()
                                if on_card else 0),
           **served,
           "sessions_live_before": live0,
           "ids_checked": truth.ids_checked - ids_checked0,
           "model_path_frac": st["model_path_frac"],
           "files_per_level": [len(lvl) for lvl in truth.store.tree.levels],
           "launches": launches, "card": card}
    return rec, launches, truth.engine_sets


def _cut(arch: str, dtype: str = "float32", units: dict = I_UNITS):
    """``arch`` at full width, cut to ``units[arch]`` pattern units."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_units=units[arch],
                               dtype=dtype)


def _set_gates(params) -> None:
    """Every gate leaf (cross-attention and its MLP's) to I_GATE."""
    for name, p in params.named_parameters():
        if "gate" in name:
            p.data.fill_(I_GATE)


def _run(params, cfg, toks, aux: dict, steps: int, device: str):
    """``forward`` over ``toks`` and ``steps`` decode steps of its first
    tokens: (forward logits, decode logits), float32 on the CPU."""
    import torch
    from repro_torch.models import decode_step, forward, init_caches

    aux = {k: v.to(device) for k, v in aux.items()}
    full = forward(params, cfg, tokens=toks.to(device), aux=aux)[0]
    caches = init_caches(cfg, toks.shape[0], toks.shape[1], device=device)
    dec = torch.cat([decode_step(params, cfg, caches,
                                 tokens=toks[:, i:i + 1].to(device),
                                 aux=aux)[0] for i in range(steps)], dim=1)
    return full.float().cpu(), dec.float().cpu()


def _err(got, want) -> dict:
    import torch
    return {"max_abs_err": float((got - want).abs().max()),
            "logit_scale": float(want.abs().max()),
            "finite": bool(torch.isfinite(got).all())}


def moe_logit_readings(seed: int, device: str) -> dict:
    """Phase I2 at full width, cut depth (I_UNITS), float32 unless named:
    per arch the card's ``forward`` over I_CHECK_B x I_CHECK_S tokens and
    its first I_CHECK_STEPS decode steps against the same port on the CPU
    from the same parameters (llama-3.2-vision's gates at I_GATE, random
    image embeddings); deepseek's ``mla_decode`` of its first layer, step
    by step over I_MLA_T tokens, against ``mla_attention``; and deepseek
    in bf16 against f32 on the card: the logits, and the share of (layer,
    token) positions whose top-k experts differ."""
    import torch
    from repro_torch.models import Model, init_params
    from repro_torch.models import attention as att
    from repro_torch.models import moe

    def init(cfg, i):
        return init_params(cfg, torch.Generator(device=device).manual_seed(
            seed + 100 + i), device=device)

    out = {}
    for i, arch in enumerate(I_UNITS):
        cfg = _cut(arch)
        t0 = time.perf_counter()
        params = init(cfg, i)
        _set_gates(params)
        rng = np.random.default_rng(seed + 200 + i)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (
            I_CHECK_B, I_CHECK_S)).astype(np.int32))
        aux = ({"image_embed": torch.from_numpy(rng.standard_normal(
            (I_CHECK_B, cfg.n_image_tokens, cfg.d_model)).astype(
                np.float32))} if cfg.n_image_tokens else {})
        with torch.inference_mode():
            card = _run(params, cfg, toks, aux, I_CHECK_STEPS, device)
            cpu = _run(Model(cfg, _float_copy(params.tree())), cfg, toks,
                       aux, I_CHECK_STEPS, "cpu")
            rec = {"layers": cfg.n_layers, "params": cfg.param_count(),
                   "forward": _err(card[0], cpu[0]),
                   "decode": _err(card[1], cpu[1])}
            if cfg.mla:
                p = params.blocks[0].p["attn"]
                x = torch.from_numpy(rng.standard_normal(
                    (2, I_MLA_T, cfg.d_model)).astype(np.float32)).to(device)
                full = att.mla_attention(x, p, cfg)
                c = {"c_kv": torch.zeros(2, I_MLA_T, cfg.kv_lora_rank,
                                         device=device),
                     "k_rope": torch.zeros(2, I_MLA_T, cfg.qk_rope_dim,
                                           device=device),
                     "pos": torch.zeros((), dtype=torch.int32,
                                        device=device)}
                steps = []
                for t in range(I_MLA_T):
                    o, c = att.mla_decode(x[:, t:t + 1], p, cfg, c)
                    steps.append(o)
                rec["mla_decode_vs_attention"] = _err(
                    torch.cat(steps, 1).cpu(), full.cpu())
                # init_params draws in f32 and casts: the same draws
                rec["bf16_vs_f32"] = _routing_readings(
                    params, init(_cut(arch, "bfloat16"), i), toks.to(device),
                    moe)
        rec["s"] = time.perf_counter() - t0
        out[arch] = rec
        del params
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
    return out


def _routing_readings(p32, p16, toks, moe) -> dict:
    """``forward`` of ``p16`` against ``p32`` on ``toks``: the logits and
    the share of (layer, token) positions whose top-k experts differ."""
    import torch
    from repro_torch.models import forward

    def routed(params):
        seen, real = [], moe.route

        def spy(xg, router, K, C):
            r = real(xg, router, K, C)
            seen.append(torch.sort(r[1], dim=-1).values)
            return r
        moe.route = spy
        try:
            logits = forward(params, params.cfg, tokens=toks)[0].float().cpu()
        finally:
            moe.route = real
        return logits, torch.stack(seen).cpu()

    l32, r32 = routed(p32)
    l16, r16 = routed(p16)
    differ = (r32 != r16).any(dim=-1)
    return {**_err(l16, l32), "positions": int(differ.numel()),
            "routing_differs": int(differ.sum()),
            "routing_differs_share": float(differ.float().mean())}


def moe_logit_checks(seed: int, device: str) -> dict:
    """:func:`moe_logit_readings`, the card's f32 within I_F32_TOL of the
    CPU's largest logit and ``mla_decode`` within I_MLA_TOL of
    ``mla_attention``'s largest output."""
    out = moe_logit_readings(seed, device)
    for arch, rec in out.items():
        for tag, tol in (("forward", I_F32_TOL), ("decode", I_F32_TOL),
                         ("mla_decode_vs_attention", I_MLA_TOL)):
            if tag not in rec:
                continue
            r = rec[tag]
            r["tol"] = tol * r["logit_scale"]
            if not r["finite"] or r["max_abs_err"] > r["tol"]:
                fail(f"phase I2: {arch} {tag} differs by {r['max_abs_err']} "
                     f"(tolerance {r['tol']})")
    out["shape"] = {"B": I_CHECK_B, "S": I_CHECK_S, "steps": I_CHECK_STEPS,
                    "mla_T": I_MLA_T, "gate": I_GATE}
    return out


# ----------------------------------------------------------------------------
# the recurrent model served over the same session index (phase J)
# ----------------------------------------------------------------------------

J_ARCH = "hymba-1.5b"     # attention and Mamba heads in parallel a layer
J_REQUESTS = 256
# J2's cut depths: hymba 2 layers, xlstm one unit (7 mLSTM, 1 sLSTM);
# xlstm's caches at 256 slots (180.6 GB) rule out serving it on one card
J2_UNITS = {"hymba-1.5b": 2, "xlstm-1.3b": 1}
# the chunked side of each cell's threshold: two chunks of MAMBA_CHUNK,
# two of MLSTM_CHUNK
J2_LONG = {"hymba-1.5b": 1024, "xlstm-1.3b": 512}
J2_B, J2_S, J2_STEPS, J2_DECODE_T = 2, 8, 4, 8
# Bounds, of the largest logit, per arch: card f32 against CPU f32, and the
# card's decode against its forward.  Set between readings on an NVIDIA
# H100 80GB HBM3, 700.00 W (port/scripts/ssm_tol_control.py, seeds 0-3):
# the sound port's, beside the model's own float32 sensitivity (the CPU's
# logits moved by one ulp of noise on the embeddings,
# ``cpu_ulp_perturbation``), and those of controls with TF32 products on
# the card, everywhere or in the mLSTM cell alone.
# hymba: card against CPU read at most 2.5e-6 (nudge 1.1e-6), TF32 at
# least 8.8e-4: I2's 2^-15 is 12x the one, 29x below the other; decode
# against forward at most 1.1e-6, TF32 at least 4.3e-4, and 2^-17 is 7.2x
# the one, 56x below the other.  xlstm: each mLSTM layer turns the rounding
# of its 4096-wide gate and 1024-wide score products into relative error
# through exp, and seven of them compound it: the nudge alone moves its
# logits 3.2e-5 to 3.5e-4 by seed.  Card against CPU read at most 1.4e-3,
# the TF32 controls at least 1.2e-2: 2^-8 is 2.9x the one, 3.1x below the
# other.  Decode against forward read at most 5.9e-4 (seed 1; 2.5e-5 at
# seed 0), the controls at least 1.2e-2: 2^-9 is 3.3x the one, 6.2x below
# the other.
J2_F32_TOL = {"hymba-1.5b": I_F32_TOL, "xlstm-1.3b": 2.0 ** -8}
J2_DECODE_TOL = {"hymba-1.5b": 2.0 ** -17, "xlstm-1.3b": 2.0 ** -9}
J2_ULP = 2.0 ** -23      # relative noise on the embeddings: one f32 ulp


def ssm_logit_readings(seed: int, device: str) -> dict:
    """Phase J2 at full width, cut depth (J2_UNITS), float32: per arch the
    card's ``forward`` over J2_B x J2_S tokens and over J2_B x J2_LONG
    tokens (both sides of the chunk threshold) and its first J2_STEPS
    decode steps, each against the same port on the CPU from the same
    parameters; and on the card, J2_DECODE_T decode steps against
    ``forward`` over the same tokens (the recurrent decode against the
    scan).  Also, as the model's own float32 sensitivity beside those
    bounds, the CPU's ``forward`` over the J2_S tokens with every
    embedding row scaled by 1 + J2_ULP x N(0, 1) against the unscaled
    one (``cpu_ulp_perturbation``)."""
    import torch
    from repro_torch.models import Model, forward, init_params

    out = {}
    for i, arch in enumerate(J2_UNITS):
        cfg = _cut(arch, units=J2_UNITS)
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=device).manual_seed(
            seed + 300 + i), device=device)
        cpu = Model(cfg, _float_copy(params.tree()))
        rng = np.random.default_rng(seed + 400 + i)
        long = torch.from_numpy(rng.integers(0, cfg.vocab, (
            J2_B, J2_LONG[arch])).astype(np.int32))
        toks = long[:, :J2_DECODE_T]
        with torch.inference_mode():
            card = _run(params, cfg, toks, {}, J2_DECODE_T, device)
            host = _run(cpu, cfg, toks, {}, J2_STEPS, "cpu")
            card_long = forward(params, cfg, tokens=long.to(device))[0]
            host_long = forward(cpu, cfg, tokens=long)[0]
            tree = cpu.tree()
            g = torch.Generator().manual_seed(seed + 500 + i)
            tree["embed"] = tree["embed"] * (1 + J2_ULP * torch.randn(
                tree["embed"].shape, generator=g))
            nudged = forward(Model(cfg, tree), cfg, tokens=toks[:, :J2_S])[0]
        out[arch] = {
            "layers": cfg.n_layers, "params": cfg.param_count(),
            "cpu_ulp_perturbation": _err(nudged, host[0][:, :J2_S]),
            "forward": _err(card[0][:, :J2_S], host[0][:, :J2_S]),
            "forward_long": _err(card_long.float().cpu(), host_long),
            "decode": _err(card[1][:, :J2_STEPS], host[1]),
            "decode_vs_forward": _err(card[1], card[0]),
            "s": time.perf_counter() - t0}
        del params, cpu, card_long, host_long, tree, nudged
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
    return out


def ssm_logit_checks(seed: int, device: str) -> dict:
    """:func:`ssm_logit_readings`, card against CPU within J2_F32_TOL of the
    CPU's largest logit and decode against forward within J2_DECODE_TOL of
    forward's."""
    out = ssm_logit_readings(seed, device)
    for arch, rec in out.items():
        f32_tol = J2_F32_TOL[arch]
        for tag, tol in (("forward", f32_tol), ("forward_long", f32_tol),
                         ("decode", f32_tol),
                         ("decode_vs_forward", J2_DECODE_TOL[arch])):
            r = rec[tag]
            r["tol"] = tol * r["logit_scale"]
            if not r["finite"] or r["max_abs_err"] > r["tol"]:
                fail(f"phase J2: {arch} {tag} differs by {r['max_abs_err']} "
                     f"(tolerance {r['tol']})")
    out["shape"] = {"B": J2_B, "S": J2_S, "long": J2_LONG,
                    "steps": J2_STEPS, "decode_T": J2_DECODE_T}
    return out


# ----------------------------------------------------------------------------
# phases K and K2: training
# ----------------------------------------------------------------------------

K_ARCH = "qwen2-0.5b"     # the arch of launch/train.py and the example
K_SEQ, K_BATCH = 1024, 8  # tokens a sequence, sequences a step
K_STEPS = 12
K_CKPT_EVERY = 6          # run 1 commits step 6's checkpoint ...
K_FAIL_AT = 9             # ... and fails at step 9; run 2 resumes at 7
K_PROFILE_FROM = 8        # run 2's steps 8-11 run under torch.profiler
K_PROFILE_STEPS = 4
# K2: f32 at full width, cut depth; the card (remat "full") against the
# CPU (remat "none") from the same parameters, TF32 off
K2_UNITS = {"qwen2-0.5b": 2, "hymba-1.5b": 2}
K2_B, K2_S = 2, 16
# Bounds, set between readings on an NVIDIA H100 80GB HBM3, 700.00 W
# (port/scripts/train_tol_control.py, seeds 0-3, both archs): the sound
# port's, and controls' with a fault on the card, each bound the power of
# two nearest the geometric mean of the largest sound reading and the
# smallest fault reading.  Loss, of the CPU's: sound at most 9.0e-8 (one
# f32 ulp at 12), every float32 product in TF32 at least 2.0e-6; 2^-21 is
# 5.3x the one, 4.2x below the other.  Gradient leaves, of each leaf's
# largest magnitude: sound at most 4.9e-6 (hymba's mamba.A_log), TF32
# at least 1.2e-3; 2^-14 is 12.5x the one, 20x below the other.  One
# AdamW step on identical trees, of each leaf's largest magnitude
# (parameters, master, m, v): sound at most 4.1e-7 (v of qwen2's attn.bq,
# seed 1: the clip scale differs by an ulp, as the two devices sum the
# global norm in another order); weight decay dropped at least 3.0e-5,
# moments kept in bf16 at least 3.3e-3 (TF32 touches no product there);
# 2^-18 is 9.2x the one, 7.9x below the weight-decay fault.
K2_LOSS_TOL = 2.0 ** -21   # of the CPU's loss
K2_GRAD_TOL = 2.0 ** -14   # of each gradient leaf's largest magnitude
K2_ADAMW_TOL = 2.0 ** -18  # of each leaf's largest magnitude, after one step


class StepClock:
    """Installed as a trainer's ``step_fn``: times each step with the card
    synchronized on both sides, and runs torch.profiler over
    K_PROFILE_STEPS steps from ``profile_from`` (a step number), the wall
    clock between the first profiled step's start and the last one's end
    (the trainer's host work between steps included)."""

    def __init__(self, tr, start: int, profile_from: int | None = None):
        self.fn, self.step = tr.step_fn, start
        tr.step_fn = self
        self.profile_from = profile_from
        self.times, self.prof, self.profile = [], None, None

    def __call__(self, *args):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        if self.step == self.profile_from:
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t_prof = time.perf_counter()
        t0 = time.perf_counter()
        out = self.fn(*args)
        torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)
        self.step += 1
        if self.prof is not None and \
                self.step == self.profile_from + K_PROFILE_STEPS:
            wall = time.perf_counter() - self.t_prof
            t0 = time.perf_counter()
            self.close()
            self.profile = {"steps": K_PROFILE_STEPS,
                            **device_summary(self.done, wall)}
            # the profiler's own close and summary, not a training cost
            self.profile["teardown_s"] = time.perf_counter() - t0
        return out

    def close(self) -> None:
        """Ends an open profiler window (also when the run stopped)."""
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.done, self.prof = self.prof, None


class CkptWatch:
    """While installed: times every checkpoint write (``ckpt.save``, on
    the saver's thread) with its bytes, keeps the host tree written at
    step ``keep``, and times the trainer's ``restore``."""

    def __init__(self, keep: int):
        self.keep, self.kept = keep, None
        self.saves, self.restores = [], []

    def __enter__(self):
        from repro_torch.checkpoint import ckpt
        from repro_torch.train import trainer
        self.ckpt, self.trainer = ckpt, trainer
        self._save, self._restore = ckpt.save, trainer.restore

        def save(tree, directory, step):
            t0 = time.perf_counter()
            d = self._save(tree, directory, step)
            self.saves.append({"step": step,
                               "s": time.perf_counter() - t0,
                               "bytes": sum(f.stat().st_size
                                            for f in d.iterdir())})
            if step == self.keep:
                self.kept = tree
            return d

        def restore(*args, **kw):
            t0 = time.perf_counter()
            out = self._restore(*args, **kw)
            self.restores.append(time.perf_counter() - t0)
            return out

        ckpt.save, trainer.restore = save, restore
        return self

    def __exit__(self, *exc):
        self.ckpt.save, self.trainer.restore = self._save, self._restore


def _timed_snapshots(tr) -> list:
    """Times the trainer's ``save_async`` calls (the wait for the save in
    flight and the host snapshot); returns the list they go into."""
    out, inner = [], tr.saver.save_async

    def save_async(*args):
        t0 = time.perf_counter()
        inner(*args)
        out.append(time.perf_counter() - t0)
    tr.saver.save_async = save_async
    return out


def _bytes_of(t):
    """A tensor's bytes as a flat uint8 tensor on the CPU."""
    import torch
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def drive_train(seed: int, card: str, device: str = "cuda",
                cfg=None) -> dict:
    """Phase K: K_ARCH at full width and depth in bf16 with the f32 master
    (``AdamWConfig()``), trained by ``Trainer`` over ``synthetic_tokens``
    (DataConfig(seq_len=K_SEQ, global_batch=K_BATCH), remat "none", as
    ``launch/train.py`` and the example train), in a temporary directory
    removed at the end.  Run 1 checkpoints at step K_CKPT_EVERY and fails
    at K_FAIL_AT; run 2's ``init_or_restore`` is held leaf by leaf, bit
    for bit, to what run 1 wrote (bf16 leaves as bf16), then run 2 trains
    (restoring again) to step K_STEPS - 1 with its steps from
    K_PROFILE_FROM profiled.  Fails unless every loss is finite
    and the last is below step 0's.  Returns the phase's record.  ``cfg``
    replaces K_ARCH's config (a CPU rehearsal with its smoke config)."""
    import torch
    from repro_torch.checkpoint.ckpt import latest_step
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataConfig, TokenDataset,
                                           synthetic_tokens)
    from repro_torch.launch.steps import TrainConfig
    from repro_torch.models.layers import tree_paths
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = cfg or get_config(K_ARCH)
    tokens = synthetic_tokens(K_SEQ * K_BATCH * (K_STEPS + 4) + 1,
                              cfg.vocab, seed)
    ds = TokenDataset(tokens, DataConfig(seq_len=K_SEQ, global_batch=K_BATCH,
                                         seed=seed, vocab=cfg.vocab))
    d = tempfile.mkdtemp(prefix="chip_smoke_train_")

    def trainer(fail_at):
        return Trainer(cfg, TrainerConfig(
            steps=K_STEPS, ckpt_every=K_CKPT_EVERY, ckpt_dir=d, log_every=1,
            fail_at_step=fail_at, train=TrainConfig(remat="none")), ds,
            device=device)

    rec = {"phase": "K", "arch": K_ARCH, "layers": cfg.n_layers,
           "params": cfg.param_count(), "dtype": cfg.dtype,
           "master_f32": True, "seq": K_SEQ, "batch": K_BATCH,
           "steps": K_STEPS, "ckpt_every": K_CKPT_EVERY,
           "fail_at": K_FAIL_AT, "remat": "none",
           "disk_free_bytes": shutil.disk_usage(d).free}
    clocks = []
    try:
        torch.cuda.reset_peak_memory_stats()
        with CkptWatch(K_CKPT_EVERY) as cw:
            t0 = time.perf_counter()
            tr1 = trainer(K_FAIL_AT)
            clocks.append(StepClock(tr1, 0))
            snaps = _timed_snapshots(tr1)
            try:
                tr1.run()
            except RuntimeError as e:
                if f"injected failure at step {K_FAIL_AT}" not in str(e):
                    raise
            else:
                fail("phase K: run 1 ran past its injected failure")
            rec["run1_s"] = time.perf_counter() - t0
            if latest_step(d) != K_CKPT_EVERY:
                fail(f"phase K: latest committed step {latest_step(d)}, "
                     f"expected {K_CKPT_EVERY}")
            metrics = list(tr1.metrics)
            del tr1
            gc.collect()
            tr2 = trainer(None)
            clocks.append(StepClock(tr2, K_CKPT_EVERY + 1, K_PROFILE_FROM))
            snaps += _timed_snapshots(tr2)
            t0 = time.perf_counter()
            params, opt, start = tr2.init_or_restore()   # as run() will
            rec["init_or_restore_s"] = time.perf_counter() - t0
            if start != K_CKPT_EVERY + 1:
                fail(f"phase K: run 2 resumes at step {start}")
            got = dict(tree_paths({"p": params.tree(), "o": opt}))
            kept = cw.kept
            if kept is None or set(got) != set(kept):
                fail("phase K: the restored leaves are not the saved ones")
            bad = [n for n, t in got.items()
                   if t.dtype != kept[n].dtype or t.shape != kept[n].shape
                   or not torch.equal(_bytes_of(t), _bytes_of(kept[n]))]
            bf16 = [n for n, t in got.items() if t.dtype == torch.bfloat16]
            if bad or not bf16 or any(kept[n].dtype != torch.bfloat16
                                      for n in bf16):
                fail(f"phase K: {len(bad)} restored leaves differ from "
                     f"step {K_CKPT_EVERY}'s save ({bad[:4]}); "
                     f"{len(bf16)} bf16")
            rec["restored"] = {"leaves": len(got), "bf16_leaves": len(bf16),
                               "mismatched_leaves": 0}
            del got, kept, params, opt
            cw.kept = None
            gc.collect()
            t0 = time.perf_counter()
            tr2.run()
            rec["run2_s"] = time.perf_counter() - t0
            metrics += tr2.metrics
            del tr2
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    finally:
        for c in clocks:
            c.close()
        shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    losses = [(m["step"], m["loss"]) for m in metrics]
    first = next(l for s, l in losses if s == 0)
    last = next(l for s, l in losses if s == K_STEPS - 1)
    if not all(np.isfinite(l) for _, l in losses) or not last < first:
        fail(f"phase K: losses {losses}")
    # run 2 replays steps 7-8 of run 1 from step 6's checkpoint
    replay = {s: [l for t, l in losses if t == s]
              for s in range(K_CKPT_EVERY + 1, K_FAIL_AT)}
    steady = sorted(clocks[0].times[1:] + clocks[1].times[1:])
    step_s = steady[len(steady) // 2]
    rec.update({
        "loss_first": first, "loss_last": last, "losses": losses,
        "grad_norm": [(m["step"], m["grad_norm"]) for m in metrics],
        "replayed_loss_diff": {s: abs(v[0] - v[1]) for s, v in
                               replay.items()},
        "step_s": {"run1": clocks[0].times, "run2": clocks[1].times},
        "step_s_median": step_s, "steps_per_s": 1 / step_s,
        "tokens_per_s": K_SEQ * K_BATCH / step_s,
        "profile": clocks[1].profile,
        "ckpt_bytes": cw.saves[0]["bytes"], "saves": cw.saves,
        "snapshot_s": snaps, "restore_s": cw.restores, "card": card})
    return rec


def train_grad_readings(seed: int, device: str, tf32: bool = False,
                        card_adamw=None) -> dict:
    """Phase K2 at full width, cut depth (K2_UNITS), float32, TF32 off:
    per arch the card's ``loss_fn`` (remat "full") and every gradient leaf
    against the CPU's (remat "none") from the same parameters, on a
    K2_B x K2_S batch drawn from a seed; then one ``adamw_update`` on
    identical trees (the CPU's gradients on both sides).  Errors: the
    loss's against the CPU's, each leaf's largest difference over its
    largest magnitude (the worst leaves listed).  Controls with a known
    fault on the card (the CPU side is unchanged): ``tf32`` lets the
    card's float32 products run in TF32, ``card_adamw`` replaces
    ``adamw_update`` on the card."""
    import torch
    from repro_torch.models import Model, init_params, loss_fn
    from repro_torch.models.layers import (tree_leaves, tree_map, tree_paths,
                                           tree_unflatten)
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32

    def grads(model, batch, remat):
        tree = model.tree()
        loss, _ = loss_fn(model, model.cfg, batch, remat=remat)
        return loss.detach(), tree_unflatten(
            tree, torch.autograd.grad(loss, tree_leaves(tree)))

    def rel(got, want) -> float:
        got, want = got.detach().float().cpu(), want.detach().float().cpu()
        if not bool(torch.isfinite(got).all()):
            return float("inf")
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        return err / scale if scale else err

    def errs(card, cpu) -> dict:
        want = dict(tree_paths(cpu))
        return {n: rel(t, want[n]) for n, t in tree_paths(card)}

    def worst(e: dict) -> dict:
        top = sorted(e.items(), key=lambda kv: -kv[1])
        return {"max": top[0][1], "worst": top[:3], "leaves": len(e)}

    out = {}
    for i, arch in enumerate(K2_UNITS):
        cfg = _cut(arch, units=K2_UNITS)
        t0 = time.perf_counter()
        card = init_params(cfg, torch.Generator(device=device).manual_seed(
            seed + 600 + i), device=device).trainable()
        cpu = Model(cfg, _float_copy(card.tree())).trainable()
        toks = torch.from_numpy(np.random.default_rng(seed + 700 + i)
                                .integers(0, cfg.vocab, (K2_B, K2_S + 1))
                                .astype(np.int32))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        lc, gc_ = grads(card, {k: v.to(device) for k, v in batch.items()},
                        "full")
        lh, gh = grads(cpu, batch, "none")
        zero = [n for (n, g), (_, h) in zip(tree_paths(gc_),
                                            tree_paths(gh))
                if bool((h != 0).any()) and not bool((g != 0).any())]
        rec = {"layers": cfg.n_layers, "params": cfg.param_count(),
               "loss": {"card": float(lc), "cpu": float(lh),
                        "rel_err": abs(float(lc) - float(lh))
                        / abs(float(lh))},
               "grads": {**worst(errs(gc_, gh)),
                         "zero_where_cpu_is_not": zero}}
        # one AdamW step on identical trees: the CPU's gradients both sides
        ocfg = AdamWConfig()
        st_c, st_h = adamw_init(card, ocfg), adamw_init(cpu, ocfg)
        (card_adamw or adamw_update)(
            card, tree_map(lambda g: g.to(device), gh), st_c, ocfg)
        adamw_update(cpu, gh, st_h, ocfg)
        e = {f"p.{n}": v for n, v in errs(card.tree(), cpu.tree()).items()}
        for key in ("m", "v", "master"):
            e.update({f"{key}.{n}": v
                      for n, v in errs(st_c[key], st_h[key]).items()})
        rec["adamw"] = worst(e)
        rec["s"] = time.perf_counter() - t0
        out[arch] = rec
        del card, cpu, gc_, gh, st_c, st_h
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
    return out


def train_grad_checks(seed: int, device: str) -> dict:
    """:func:`train_grad_readings` within K2_LOSS_TOL, K2_GRAD_TOL and
    K2_ADAMW_TOL, and no gradient leaf zero on the card where the CPU's is
    not."""
    out = train_grad_readings(seed, device)
    for arch, rec in out.items():
        for tag, err, tol in (
                ("loss", rec["loss"]["rel_err"], K2_LOSS_TOL),
                ("grads", rec["grads"]["max"], K2_GRAD_TOL),
                ("adamw", rec["adamw"]["max"], K2_ADAMW_TOL)):
            rec[tag]["tol"] = tol
            if not err <= tol:
                fail(f"phase K2: {arch} {tag} differs by {err} "
                     f"(tolerance {tol}; {rec[tag]})")
        if rec["grads"]["zero_where_cpu_is_not"]:
            fail(f"phase K2: {arch} gradient leaves zero on the card: "
                 f"{rec['grads']['zero_where_cpu_is_not']}")
    out["shape"] = {"B": K2_B, "S": K2_S, "units": K2_UNITS,
                    "tf32": False}
    return out


# the port's examples, each run as its own process on the card: the lines
# each must print (the reference example's facts)
EXAMPLES = {"quickstart.py": ("hit rate 1.000", "model_path=100.0%"),
            "serve_kv_cache.py": ("served 16 requests in 24 engine steps",),
            "train_lm.py": ("over 200 steps",)}


def run_examples() -> dict:
    """``port/examples/quickstart.py``, ``serve_kv_cache.py`` and
    ``train_lm.py`` as subprocesses on the card (their default device), at
    their defaults: each must exit 0 and print its lines of EXAMPLES
    (``train_lm.py`` exits non-zero unless its loss falls)."""
    out = {}
    for name, lines in EXAMPLES.items():
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable,
                            os.path.join(HERE, "port", "examples", name)],
                           capture_output=True, text=True, timeout=600,
                           cwd=HERE)
        got = r.stdout.splitlines()
        missing = [ln for ln in lines if not any(ln in g for g in got)]
        if r.returncode != 0 or missing:
            fail(f"example {name} exited {r.returncode}, missing {missing}: "
                 f"{r.stderr[-2000:]}")
        out[name] = {"s": time.perf_counter() - t0, "stdout": got}
    return out


# ----------------------------------------------------------------------------
# the launch layer: the store cell, the model plans, steps under rules (L)
# ----------------------------------------------------------------------------

L_CELLS = (("qwen2-0.5b", "train_4k"), ("deepseek-v2-lite-16b", "decode_32k"),
           ("hymba-1.5b", "long_500k"))
L_DEPTH_CELL = ("qwen2-0.5b", "train_4k")   # also planned at units 1 and 2
L_MULTI_CELL = ("hymba-1.5b", "long_500k")  # also on the (2, 16, 16) mesh
L3_BATCH, L3_SEQ, L3_STEPS = 4, 512, 2
STORE_KERNELS = ("plr_lookup", "bounded_search")
STORE_ROW_SEED = 7      # the store shape's "in_row" probe sets
DEPTH_TOL = 1e-6        # L2's full-plan FLOPs against units 1 and 2


def drive_store_cell(card: str) -> dict:
    """Phase L1: ``python -m repro_torch.launch.dryrun --store`` at its
    defaults (2^30 keys in 256 shard rows of 2^22 on the (16, 16) mesh of
    the card repeated, GETs of 2^20 probes, half of them absent), as a
    process of its own; it checks every answer and fails on a wrong one.
    Fails unless ``plr_lookup`` and ``bounded_search`` launched once a
    mesh position a GET and no other kernel launched.  Returns its
    record."""
    d = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        out = os.path.join(d, "store.json")
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "port"))
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                            "--store", "--out", out], capture_output=True,
                           text=True, timeout=600, cwd=HERE, env=env)
        if r.returncode != 0:
            fail(f"the store cell exited {r.returncode}: {r.stderr[-3000:]}")
        with open(out) as f:
            rec = json.load(f)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    rec["process_s"] = time.perf_counter() - t0
    m = rec["measured"]
    want = {name: (rec["n_devices"] if name in STORE_KERNELS else 0)
            for name in KERNELS}
    if m["launches_per_get"] != want:
        fail(f"store cell launches a GET {m['launches_per_get']}, expected "
             f"{want}")
    from repro_torch.launch.dryrun import STORE_GETS
    if m["answers_checked"] != STORE_GETS * rec["probe_batch"]:
        fail(f"the store cell checked {m['answers_checked']} answers")
    return rec


def store_shape_checks(rec: dict) -> dict:
    """``plr_lookup`` and ``bounded_search`` against their plain versions
    on mesh position 0's shard row of the store cell (2^22 keys, a model
    of 512 segments) over TIMED_BATCHES sets of 2^20 probes of two kinds:
    "gathered", the cell's GET batches as every position sees them (the
    whole batch against row 0: about one probe in 256 falls in the row,
    the rest clamp to its ends), and "in_row", probes drawn from row 0's
    own keys, half of them moved to the absent key after (every probe a
    real bisect and window).  ``bounded_search`` gets the plain positions.
    The bounds count bytes that many probes share once
    (``_distinct_plr_work``, ``_distinct_bounded_work``).  Returns
    {kernel: {"store_shape": gathered record, "store_row_shape": in_row
    record}}."""
    import torch
    from repro_torch.core.distributed import DistStoreConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.dryrun import (_store_segments, store_keys,
                                           store_probes, store_row)
    dev = torch.device("cuda")
    S = rec["n_devices"]
    cfg = DistStoreConfig(n_keys=rec["n_keys"], probe_batch=rec["probe_batch"])
    row = store_row(0, S, cfg, dev)
    tables = (row["starts"], row["slopes"], row["icepts"], row["nseg"],
              row["n"])
    rows = torch.zeros(cfg.probe_batch, dtype=torch.int32, device=dev)
    seg = _store_segments(S, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(STORE_ROW_SEED)
    absent = (torch.arange(cfg.probe_batch, device=dev) % 2).to(torch.int64)

    def in_row():
        i = torch.randint(0, int(row["n"][0]), (cfg.probe_batch,),
                          generator=gen, dtype=torch.int64, device=dev)
        return store_keys(seg, i) + absent

    out = {name: {} for name in STORE_KERNELS}
    for kind, draw in (("store_shape",
                        lambda g: store_probes(cfg, g, dev, S)[0]),
                       ("store_row_shape", lambda g: in_row())):
        sets = []
        for g in range(TIMED_BATCHES):
            p = draw(g)
            sets.append((rows, p, ref.plr_lookup_rows_ref(*tables, rows, p)))
        shape = {"S": row["starts"].shape[1], "nseg": int(row["nseg"][0]),
                 "C": row["keys"].shape[1], "B": cfg.probe_batch, "rows": S,
                 "in_row": sum(int(((p >= row["lo"][0])
                                    & (p <= row["hi"][0])).sum())
                               for _, p, _ in sets) / len(sets)}
        out["plr_lookup"][kind] = {**_measure(
            *_plr_fns(tables, sets), _distinct_plr_work(tables, sets),
            _symbol("plr_lookup")), "shape": shape}
        out["bounded_search"][kind] = {**_measure(
            lambda i: ops.bounded_search(row["keys"], row["n"], rows,
                                         sets[i][2], sets[i][1], cfg.delta),
            lambda i: ref.bounded_search_rows_ref(row["keys"], row["n"], rows,
                                                  sets[i][2], sets[i][1],
                                                  cfg.delta),
            _distinct_bounded_work(row["keys"], sets, cfg.delta),
            _symbol("bounded_search")), "shape": shape}
        del sets
    del row, seg
    torch.cuda.empty_cache()
    return out


def drive_plans(card: str) -> dict:
    """Phase L2: the dry run's plans of L_CELLS on the (16, 16) mesh at
    full width and depth, L_DEPTH_CELL again at ``units`` 1 and 2, and
    L_MULTI_CELL on the (2, 16, 16) mesh, written as the sweep writes
    them; then ``roofline.report`` over them, printed.  Fails on a cell
    without a plan or a report row, and unless the reference's depth
    extrapolation (``roofline._extrapolated``) from units 1 and 2 gives
    L_DEPTH_CELL's full-depth FLOPs within DEPTH_TOL: the plan counts
    every layer's products alike.  Its bytes are extrapolated and
    reported, not held: each layer's backward through its row of the
    stacked leaves writes a zero gradient of the whole stack, so the
    bytes grow with depth squared, which a line through two depths
    misses (the reason ``analyze_cell`` reads the full plan).  Returns
    {cell: summary}."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, roofline
    d = tempfile.mkdtemp(prefix="chip_smoke_plans_")
    runs = [(a, s, None, False) for a, s in L_CELLS]
    runs += [(*L_DEPTH_CELL, u, False) for u in (1, 2)]
    runs.append((*L_MULTI_CELL, None, True))
    out = {}
    try:
        for arch, shape, units, multi in runs:
            t0 = time.perf_counter()
            rec = dryrun.run_cell(arch, shape, units=units, multi_pod=multi,
                                  metering=units is not None)
            if "memory" not in rec or "cost" not in rec:
                fail(f"no plan for {arch} x {shape}: {rec}")
            tag = "multi" if multi else "single"
            suffix = f"__u{units}" if units else ""
            with open(os.path.join(
                    d, f"{arch}__{shape}__{tag}{suffix}.json"), "w") as f:
                json.dump(rec, f)
            out[f"{arch}__{shape}__{tag}{suffix}"] = {
                "s": time.perf_counter() - t0, "memory": rec["memory"],
                "cost": rec["cost"], "collectives": rec["collectives"],
                "per_position_batch": rec["per_position_batch"],
                "microbatch": rec["microbatch"]}
        full, u1, u2 = (out[f"{L_DEPTH_CELL[0]}__{L_DEPTH_CELL[1]}__single"
                            f"{sfx}"] for sfx in ("", "__u1", "__u2"))
        n_units = get_config(L_DEPTH_CELL[0]).n_units
        for key in ("flops", "bytes accessed"):
            est = roofline._extrapolated(full, u1, u2, key, n_units)
            rel = abs(est / full["cost"][key] - 1)
            full.setdefault("depth_check", {})[key] = {
                "full": full["cost"][key], "from_units_1_2": est, "rel": rel}
            if key == "flops" and rel > DEPTH_TOL:
                fail(f"L2: {key} of {L_DEPTH_CELL} extrapolated from units "
                     f"1 and 2 is {est}, the full plan {full['cost'][key]}")
        for tag in ("single", "multi"):
            rep = roofline.report(d, tag)
            print(f"roofline ({tag}, {card}):")
            print(rep)
            cells = roofline.load_cells(d, tag)
            for key, c in cells.items():
                if "dominant" not in c:
                    fail(f"no roofline row for {key}: {c}")
                out[f"{key}__{tag}"].update(
                    {k: c[k] for k in ("dominant", "t_compute_s",
                                       "t_memory_s", "t_collective_s",
                                       "useful_ratio", "roofline_fraction",
                                       "memory_peak_gib", "fits_hbm")})
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return out


def drive_rules_steps(seed: int, device: str = "cuda", cfg=None) -> dict:
    """Phase L3: L3_STEPS train steps of K_ARCH at full width (bf16, the
    f32 master, remat "full") on ``build_train_step`` with
    ``DEFAULT_RULES`` on a (1, 1) mesh of the device, and the same steps
    from the same ``init_params`` draw with ``rules=None``: every loss and
    every updated leaf, parameters and optimizer state, must be equal bit
    for bit.  Both run with torch's deterministic algorithms (the
    embedding gradient's accumulation is in no fixed order otherwise), so
    that what differs is the rules alone.  ``cfg`` replaces K_ARCH's
    config (a CPU rehearsal)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.engine import upload
    from repro_torch.core.mesh import make_mesh
    from repro_torch.launch.sharding import DEFAULT_RULES, ShardingRules
    from repro_torch.launch.steps import (TrainConfig, build_train_step,
                                          init_train_state)
    from repro_torch.models.layers import tree_paths
    cfg = cfg or get_config(K_ARCH)
    dev = torch.device(device)
    mesh = make_mesh((1, 1), ("data", "model"), [device])
    rng = np.random.default_rng(seed + 60)
    batches = []
    for _ in range(L3_STEPS):
        t = rng.integers(0, cfg.vocab, (L3_BATCH, L3_SEQ + 1)).astype(
            np.int32)
        batches.append({"tokens": upload(np.ascontiguousarray(t[:, :-1]),
                                         dev),
                        "labels": upload(np.ascontiguousarray(t[:, 1:]), dev)})
    runs = []
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for rules, m in ((ShardingRules(DEFAULT_RULES), mesh), (None, None)):
            tc = TrainConfig()
            gen = torch.Generator(device=dev).manual_seed(seed)
            params, opt = init_train_state(cfg, tc, gen, device)
            step = build_train_step(cfg, tc, rules, m)
            losses = []
            for b in batches:
                params, opt, met = step(params, opt, b)
                losses.append(met["loss"])
            runs.append((losses, dict(tree_paths({"p": params.tree(),
                                                  "o": opt}))))
            del params, opt
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    (la, ta), (lb, tb) = runs
    diff_losses = sum(not torch.equal(a, b) for a, b in zip(la, lb))
    diff_leaves = [n for n in ta if not torch.equal(ta[n], tb[n])]
    if diff_losses or diff_leaves:
        fail(f"phase L3: {diff_losses} losses and {len(diff_leaves)} leaves "
             f"differ under the rules (first {diff_leaves[:3]})")
    return {"steps": L3_STEPS, "batch": [L3_BATCH, L3_SEQ],
            "losses": [float(x) for x in la], "leaves_equal": len(ta),
            "mesh": [1, 1]}


def profile_steps(step, n: int) -> dict:
    """Device time of ``n`` turns of the serving loop (``step()``, False
    once drained) under torch.profiler against the wall clock; each engine
    step ends in its argmax's host read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    done = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while done < n and step():
            done += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"steps": done, **device_summary(prof, wall)}


def session_shape_checks(store, sets: list) -> dict:
    """The four descent kernels against their plain versions at phase H's
    shapes: every non-empty level of the session index's device state as
    it stands after H, on the id batches H looked up (the engine's, of up
    to max_batch ids, and the direct ones).  Per kernel: the batch sizes,
    the levels, the outputs that differ and the largest difference."""
    import torch
    from repro_torch.kernels import ref

    cfg = store.engine.cfg
    state = store.engine.build_state(store.tree)
    out = {name: {"B": sorted({p.shape[0] for p in sets}), "levels": [],
                  "sets": 0, "mismatches": 0, "max_abs_err": 0.0}
           for name in KERNELS[:4]}
    for li, lv in enumerate(state.levels):
        if lv.n_files == 0:
            continue
        dev = lv.keys.device
        models = (lv.starts, lv.slopes, lv.icepts, lv.nseg, lv.n)
        level_sets = []
        for p in sets:
            pt = torch.from_numpy(p).to(dev)
            rows = store.engine._find_file(lv, pt)[0].to(torch.int32)
            level_sets.append((rows, pt, ref.plr_lookup_rows_ref(
                *models, rows, pt)))
        fns = {"plr_lookup": _plr_fns(models, level_sets),
               "bounded_search": _bounded_fns(lv, level_sets, cfg.plr_delta),
               "bloom_probe": _bloom_fns(lv, level_sets, cfg.bloom_k),
               "sstable_search": _sstable_fns(lv, level_sets,
                                              cfg.block_records)}
        for name, (kern, plain) in fns.items():
            mism, err = _compare(kern, plain, len(level_sets))
            rec = out[name]
            rec["levels"].append({"level": li, "F": lv.keys.shape[0],
                                  "C": lv.keys.shape[1],
                                  "learned": int((lv.nseg > 0).sum())})
            rec["sets"] += len(level_sets)
            rec["mismatches"] += mism
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
    return out


M_ARCH = "command-r-plus-104b"   # 208 GB in bf16 at full depth
M_MESH, M_AXES = (2, 2), ("data", "model")
M_PROCS = 4
M_B, M_S, M_T, M_STEPS = 8, 128, 1024, 8
# the decode goes on from caches whose first M_POS slots are written (from
# the seed), so that its steps write both pieces of the context split over
# "model" (slots 508-511 and 512-515) and attend to keys in both
M_POS = M_T // 2 - M_STEPS // 2
# (dtype, pattern units of 64): M1 at full width, cut depth, bf16; M2 at
# full width, one unit, f32
M_RUNS = {"M1": ("bfloat16", 4), "M2": ("float32", 1)}
# the largest logit gap, sharded against unsharded, over the unsharded
# logits' largest magnitude; see PERF.md and port/scripts/shard_tol_control.py
M_TOL = {"M1": 2.0 ** -5, "M2": 2.0 ** -15}

# phase N: the MoE and MLA blocks on M's mesh, launcher and steps
N_ARCH = {"N1": "deepseek-v2-lite-16b", "N2": "mixtral-8x22b",
          "N3": "deepseek-v2-lite-16b"}
N_B, N_S, N_T, N_STEPS = 8, 128, 1024, 8
N_POS = N_T // 2 - N_STEPS // 2      # MLA's c_kv and mixtral's ring split
# (dtype, pattern units): N1 deepseek's dense prologue layer and 3 of its
# 26 MoE units in bf16 (4 of 27 layers); N2 one of mixtral's 56 units in
# f32; N3 deepseek's prologue layer and one MoE unit in f32 (N1's path
# held as M2 holds M1's)
N_RUNS = {"N1": ("bfloat16", 3), "N2": ("float32", 1),
          "N3": ("float32", 1)}
# as M_TOL.  N1's lies between the sound readings of
# port/scripts/shard_tol_control.py --tag N1 over seeds 0-2 (at most
# 0.1004: in bf16 about 8% of the (layer, token) routings differ between
# the two runs, each a whole expert's output) and its faults (the least,
# the cache row one slot late, 0.1375); see PERF.md.  N3 holds N1's path
# in f32 as M2 and N2 do, every routing alike
N_TOL = {"N1": 2.0 ** -3, "N2": 2.0 ** -15, "N3": 2.0 ** -15}
# runs that must route every (layer, token) position alike on both sides
N_SAME_ROUTING = ("N2", "N3")
# runs whose prefill's last N_B // 2 rows repeat one token id: they all
# route alike, past the capacity (320) of the 1024-token group, so
# assignments are dropped, on the second data rank's tokens
N_REPEAT = ("N2",)

# phase O: the recurrent and cross-attention blocks on M's mesh, launcher
# and steps, with M's and N's shapes
O_ARCH = {"O1": "hymba-1.5b", "O2": "hymba-1.5b", "O3": "xlstm-1.3b",
          "O4": "llama-3.2-vision-11b"}
O_B, O_S, O_T, O_STEPS = 8, 128, 1024, 8
O_POS = O_T // 2 - O_STEPS // 2      # hymba's ring (window 1024) split
# (dtype, pattern units): O1 2 of hymba's 32 layers in bf16; O2 one in
# f32; O3 one of xlstm's 6 units (7 mLSTM and 1 sLSTM) in f32, whose
# mLSTM state C splits on its hd (1024 = T) as the reference's cache rule
# says; O4 one of llama-3.2-vision's 8 units (4 attn_mlp and 1
# cross_attn_mlp) in f32, its gates at I_GATE and its 1600 image tokens
# a row drawn from the seed (``m_aux``)
O_RUNS = {"O1": ("bfloat16", 2), "O2": ("float32", 1),
          "O3": ("float32", 1), "O4": ("float32", 1)}
# as M_TOL.  O1's and O3's lie between the sound readings and the faults
# of port/scripts/shard_tol_control.py --tag O1|O3; see PERF.md.  O3's is
# xlstm's own conditioning, as J2_F32_TOL's: in f32 its sound seeds 0-2
# read 5.5e-4, 2.1e-4 and 2.8e-4 (the prefill; the sLSTM's time loop
# and the mLSTM's normalizer carry the split sums' rounding), the sLSTM
# carry one step stale 0.709
O_TOL = {"O1": 2.0 ** -5, "O2": 2.0 ** -15, "O3": 2.0 ** -8,
         "O4": 2.0 ** -15}
MN_RUNS = tuple(M_RUNS) + tuple(N_RUNS) + tuple(O_RUNS)


def m_run(tag: str) -> dict:
    """Phase M's, N's or O's run ``tag``: arch, dtype, pattern units,
    batch, prompt length, cache length, decode steps, slots written before
    the decode, and whether the prefill repeats one token id."""
    if tag in M_RUNS:
        return dict(arch=M_ARCH, dtype=M_RUNS[tag][0], units=M_RUNS[tag][1],
                    B=M_B, S=M_S, T=M_T, steps=M_STEPS, pos=M_POS,
                    repeat=False)
    if tag in O_RUNS:
        return dict(arch=O_ARCH[tag], dtype=O_RUNS[tag][0],
                    units=O_RUNS[tag][1], B=O_B, S=O_S, T=O_T,
                    steps=O_STEPS, pos=O_POS, repeat=False)
    return dict(arch=N_ARCH[tag], dtype=N_RUNS[tag][0],
                units=N_RUNS[tag][1], B=N_B, S=N_S, T=N_T, steps=N_STEPS,
                pos=N_POS, repeat=tag in N_REPEAT)


def m_config(tag: str):
    """Run ``tag``'s arch at full width, its pattern units, its dtype."""
    from repro_torch.configs import get_config
    run = m_run(tag)
    return dataclasses.replace(get_config(run["arch"]), n_units=run["units"],
                               dtype=run["dtype"])


def m_tokens(tag: str, cfg, seed: int) -> tuple:
    """The prompts (B, S) and the token each decode step is fed (the
    same on both runs, drawn from ``seed``: teacher-forced, so that no
    near-tie of one run's argmax changes the other's input)."""
    run = m_run(tag)
    rng = np.random.default_rng(seed + 70)
    prompts = rng.integers(0, cfg.vocab, (run["B"], run["S"])).astype(
        np.int32)
    fed = rng.integers(0, cfg.vocab, (run["steps"], run["B"], 1)).astype(
        np.int32)
    if run["repeat"]:
        prompts[run["B"] // 2:] = prompts[run["B"] // 2, 0]
    return prompts, fed


# the cache leaves with a context (or ring) dimension
M_CONTEXT_LEAVES = ("k", "v", "c_kv", "k_rope")


def m_caches(tag: str, cfg, device, seed: int):
    """``init_caches(cfg, B, T)`` on ``device`` with the first ``pos``
    slots of every context leaf (k, v, c_kv, k_rope) N(0, 1), every
    recurrent state leaf N(0, 1) whole (the normalizers ``n`` their
    magnitudes: the state a decode goes on from), drawn on the device
    from ``seed`` (the same on every process), and every ``pos`` at
    ``pos``."""
    import torch
    from repro_torch.models import init_caches

    run = m_run(tag)
    caches = init_caches(cfg, run["B"], run["T"], device=str(device))
    gen = torch.Generator(device=device).manual_seed(seed + 71)

    def fill(tree):
        for name, t in sorted(tree.items()):
            if isinstance(t, dict):
                fill(t)
            elif name == "pos":
                t.fill_(run["pos"])
            else:
                head = t[:, :, :run["pos"]] if name in M_CONTEXT_LEAVES \
                    else t
                x = torch.randn(head.shape, generator=gen, device=device,
                                dtype=torch.float32)
                head.copy_(x.abs_() if name == "n" else x)
    fill(caches)
    return caches


def m_aux(tag: str, cfg, device, seed: int) -> dict:
    """The image embeddings (B, I, D) of a config with image tokens, in
    bfloat16 (the dry run's input spec), N(0, 1) drawn on the device from
    ``seed``; else nothing."""
    import torch
    if not cfg.n_image_tokens:
        return {}
    gen = torch.Generator(device=device).manual_seed(seed + 72)
    img = torch.randn((m_run(tag)["B"], cfg.n_image_tokens, cfg.d_model),
                      generator=gen, device=device, dtype=torch.float32)
    return {"image_embed": img.to(torch.bfloat16)}


def m_leaves(cfg, gen, device):
    """``init_leaves``, every gate leaf at I_GATE (0 at init makes the
    cross-attention block the identity).  A ``map``, not a generator of
    its own: a generator's frame would hold the leaf it last yielded (a
    whole one, 11.7 GiB at command-r's embedding) until asked for the
    next, while ``shard_params`` has already dropped it."""
    from repro_torch.models import init_leaves

    def gated(leaf):
        name, t = leaf
        return name, (t.fill_(I_GATE) if "gate" in name else t)
    return map(gated, init_leaves(cfg, gen, device))


def _m_timed(fn, barrier=None) -> tuple:
    import torch
    if barrier is not None:
        barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _comm_kinds(counts: dict) -> dict:
    """CommDebugMode's counts by collective name (``all_reduce``...)."""
    return {str(k).split(".")[-1]: int(v) for k, v in counts.items()}


class SlstmLoopMeter:
    """While open, and while ``meter`` (a ``plan.ShardMeter``, or None) is
    open over the steps: the collectives, by kind, that ``meter`` saw
    inside the sLSTM's time loop (``ssm._slstm_loop``), its forward and
    its backward (from the hidden states' gradient to the input's, marked
    by hooks on both, on whatever thread autograd runs them); ``tokens``,
    the steps of the loops measured, ``loops``, how many, and
    ``backwards``, how many of their backwards ran (a forward recomputed
    under remat "full" is only a forward: autograd runs the backward of
    the first one's graph)."""

    def __init__(self, meter=None) -> None:
        self.meter = meter
        self.windows: list = []        # [meter, start, end] a pass
        self.backs: list = []          # the windows of the backwards
        self.tokens = self.loops = 0

    def __enter__(self):
        from repro_torch.models import ssm

        self.ssm, self.real = ssm, ssm._slstm_loop
        ssm._slstm_loop = self._loop
        return self

    def __exit__(self, *exc) -> None:
        self.ssm._slstm_loop = self.real

    @property
    def counts(self) -> dict:
        out: dict = {}
        for meter, start, end in self.windows:
            if start is None and end is None:
                continue                   # a graph no backward ran
            if start is None or end is None:
                raise RuntimeError("an sLSTM loop's backward never ended")
            for kind in meter.log[start:end]:
                out[kind] = out.get(kind, 0) + 1
        return out

    @property
    def backwards(self) -> int:
        return sum(w[1] is not None for w in self.backs)

    def _loop(self, wx, R, bias):
        meter = self.meter
        if meter is None:
            return self.real(wx, R, bias)
        start = len(meter.log)
        hs = self.real(wx, R, bias)
        self.windows.append([meter, start, len(meter.log)])
        self.tokens += wx.shape[1]
        self.loops += 1
        if hs.requires_grad and wx.requires_grad:
            back = [meter, None, None]
            self.windows.append(back)
            self.backs.append(back)

            def start_(g):
                back[1] = len(meter.log)
                return g

            def end_(g):
                back[2] = len(meter.log)
                return g
            hs.register_hook(start_)
            wx.register_hook(end_)
        return hs


class RouteWatch:
    """While open: each ``moe.route`` call's probabilities, experts and
    keep mask, held as the device tensors it returned (no device op, no
    host read), and ``by_tokens``: the calls whose expert rows moved to
    the weights (``moe._experts_by_tokens``; the others gathered the
    weights' pieces, or ran unsharded).  ``host()`` gives the calls
    after, as (sorted experts (tokens, K), kept (tokens, K), the k-th
    less the next expert's probability (tokens,)) numpy arrays a call,
    the tokens in this process's order."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.calls, self.by_tokens = moe, [], []
        self.real = moe.route, moe._experts_by_tokens

        def spy(xg, router, K, C, before=None):
            out = self.real[0](xg, router, K, C, before)
            self.calls.append((out[0].detach(), out[1], out[3]))
            return out

        def moved(*args):
            self.by_tokens.append(len(self.calls) - 1)
            return self.real[1](*args)
        moe.route, moe._experts_by_tokens = spy, moved
        return self

    def __exit__(self, *exc):
        self.moe.route, self.moe._experts_by_tokens = self.real

    def host(self) -> list:
        out = []
        for probs, idx, keep in self.calls:
            K = idx.shape[-1]
            top = probs.reshape(-1, probs.shape[-1]).topk(K + 1).values
            out.append((idx.sort(dim=-1).values.reshape(-1, K).cpu().numpy(),
                        keep.reshape(-1, K).cpu().numpy(),
                        (top[:, K - 1] - top[:, K]).cpu().numpy()))
        return out


def m_rank(rank: int, device, tags: tuple, seed: int) -> dict:
    """One rank of phases M and N, each run of ``tags`` in turn:
    ``m_config``'s model laid out over the process mesh under
    DEFAULT_RULES, drawn leaf by leaf with ``init_leaves`` on a generator
    seeded ``seed`` (the unsharded run's draws); the prefill of the run's
    prompts, then its decode steps on from ``m_caches``, each timed,
    every MoE routing watched; then one more prefill and decode step
    under CommDebugMode for the collectives by kind.  Returns a record a
    run, rank 0's with the global logits (float32 numpy)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.convert import shard_params
    from repro_torch.kernels import ops
    from repro_torch.launch.inputs import shard_batch, shard_caches
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.sharding import DEFAULT_RULES, ShardingRules
    from repro_torch.launch.steps import build_prefill_step, build_serve_step

    mesh = make_process_mesh(M_MESH, M_AXES, device)
    rules = ShardingRules(DEFAULT_RULES)
    out = {}
    for tag in tags:
        t_run = time.perf_counter()
        run = m_run(tag)
        cfg = m_config(tag)
        torch.cuda.reset_peak_memory_stats(device)
        ops.reset_launches()
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(seed)
        params = shard_params(m_leaves(cfg, gen, device), mesh, rules, cfg)
        init_s = time.perf_counter() - t0
        caches = shard_caches(cfg, run["B"], run["T"], mesh, rules,
                              whole=m_caches(tag, cfg, device, seed))
        prompts, fed = m_tokens(tag, cfg, seed)
        init_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        prefill = build_prefill_step(cfg, rules, mesh)
        serve = build_serve_step(cfg, rules, mesh)
        aux = m_aux(tag, cfg, device, seed)

        def batch(t):
            return shard_batch({"tokens": torch.from_numpy(t).to(device),
                                **aux}, mesh)

        logits, ms = [], []
        with RouteWatch() as routes:
            out_, t = _m_timed(lambda: prefill(params, batch(prompts)),
                               dist.barrier)
            logits.append(out_.full_tensor())
            ms.append(t)
            for tok in fed:
                (out_, caches), t = _m_timed(
                    lambda: serve(params, caches, batch(tok)), dist.barrier)
                logits.append(out_.full_tensor())
                ms.append(t)
        with CommDebugMode() as c_pre:
            prefill(params, batch(prompts))
        with CommDebugMode() as c_dec:
            serve(params, caches, batch(fed[-1]))
        local = [t.to_local() for t in params.parameters()]
        rec = {"rank": rank, "coordinate": list(mesh.coordinate),
               "device": str(device),
               "param_bytes": sum(t.numel() * t.element_size()
                                  for t in local),
               "init_s": init_s, "prefill_ms": ms[0], "decode_ms": ms[1:],
               "collectives": {
                   "prefill": _comm_kinds(c_pre.get_comm_counts()),
                   "decode_step": _comm_kinds(c_dec.get_comm_counts())},
               "init_peak_device_bytes": init_peak,
               "serving_peak_device_bytes": torch.cuda.max_memory_allocated(
                   device),
               "launches": dict(ops.launches), "routes": routes.host(),
               "by_tokens": routes.by_tokens}
        if rank == 0:
            rec["logits"] = [x.float().cpu().numpy() for x in logits]
        del params, caches, local, logits, out_, aux
        gc.collect()
        torch.cuda.empty_cache()     # the next run's ranks share the card
        rec["s"] = time.perf_counter() - t_run
        out[tag] = rec
    return out


def m_unsharded(tag: str, seed: int) -> dict:
    """Run ``tag`` on one process on cuda:0: ``init_params`` from the
    same draw, no rules, the same caches, prompts and fed tokens, each
    step timed, every MoE routing watched."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models import init_params

    cfg = m_config(tag)
    dev = torch.device("cuda:0")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         str(dev))
    _set_gates(params)
    caches = m_caches(tag, cfg, dev, seed)
    prompts, fed = m_tokens(tag, cfg, seed)
    aux = m_aux(tag, cfg, dev, seed)
    prefill, serve = build_prefill_step(cfg), build_serve_step(cfg)
    with RouteWatch() as routes:
        out, t = _m_timed(lambda: prefill(params, {
            "tokens": torch.from_numpy(prompts).to(dev), **aux}))
        logits, ms = [out.float().cpu().numpy()], [t]
        for tok in fed:
            (out, caches), t = _m_timed(lambda: serve(params, caches, {
                "tokens": torch.from_numpy(tok).to(dev), **aux}))
            logits.append(out.float().cpu().numpy())
            ms.append(t)
    rec = {"logits": logits, "prefill_ms": ms[0], "decode_ms": ms[1:],
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters()),
           "launches": dict(ops.launches), "routes": routes.host()}
    del params, caches, aux
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def moe_layers(cfg) -> int:
    """The MoE layers one pass of ``cfg``'s stack runs."""
    return sum(st.layers * (1 if st in cfg.prologue else cfg.n_units)
               for st in cfg.prologue + cfg.pattern
               if st.block.endswith("moe"))


def m_routing(ranks: list, one: dict, n_prefill: int) -> dict:
    """The sharded run's routing beside the unsharded run's: the tokens'
    (layer, token) positions whose top-k experts differ, and the
    assignments each side dropped at capacity, prefill and decode apart
    (the first ``n_prefill`` MoE calls are the prefill's, one a MoE
    layer, and so a decode step's); for each MoE layer, the positions
    that differ and the unsharded run's largest margin between the k-th
    and the next expert's probability among them (an earlier layer's
    flip moves a later layer's input by a whole expert's output), beside
    the median margin of every position; and the MoE calls (of those of
    a run) whose rows moved to the expert weights on the sharded side.
    The sharded side's tokens are the data ranks' in order, read on model
    rank 0."""
    lead = sorted((r for r in ranks if r["coordinate"][1] == 0),
                  key=lambda r: r["coordinate"][0])
    calls = [tuple(np.concatenate([r["routes"][c][j] for r in lead])
                   for j in (0, 1)) for c in range(len(one["routes"]))]
    out = {"positions": 0, "routing_differs": 0}
    for part, sl in (("prefill", slice(0, n_prefill)),
                     ("decode", slice(n_prefill, None))):
        out[f"dropped_sharded_{part}"] = int(sum(
            (~k).sum() for _, k in calls[sl]))
        out[f"dropped_unsharded_{part}"] = int(sum(
            (~r[1]).sum() for r in one["routes"][sl]))
    flips = [[] for _ in range(n_prefill)]
    for c, ((a, _), (b, _, margin)) in enumerate(zip(calls, one["routes"])):
        if a.shape != b.shape:
            fail(f"routing of {a.shape} tokens sharded, {b.shape} unsharded")
        differs = (a != b).any(axis=-1)
        out["positions"] += a.shape[0]
        out["routing_differs"] += int(differs.sum())
        flips[c % n_prefill].append(margin[differs])
    flips = [np.concatenate(f) for f in flips]
    out["routing_differs_by_layer"] = [int(f.size) for f in flips]
    out["flip_margin_max_by_layer"] = [float(f.max()) if f.size else None
                                       for f in flips]
    out["margin_median"] = float(np.median(np.concatenate(
        [r[2] for r in one["routes"]])))
    out["assignments"] = int(sum(r[1].size for r in one["routes"]))
    out["moe_calls"] = len(one["routes"])
    out["by_tokens"] = sorted({c for r in ranks for c in r["by_tokens"]})
    return out


def m_readings(tag: str, ranks: list, one: dict, layout: tuple) -> dict:
    """One run of phase M or N (``tag``): the four ranks' records and the
    unsharded run's; the gap of each step's logits over the unsharded
    logits' largest magnitude, both runs' times, the ranks' parameter
    bytes beside the plan's (``launch/dryrun.plan_cell`` on a (2, 2) mesh
    of ``meta`` positions, same config and cell), their peak device
    bytes and, for a MoE config, the routing on both sides."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.mesh import make_mesh
    from repro_torch.launch import dryrun

    run, cfg = m_run(tag), m_config(tag)
    backend, devices = layout
    t0 = time.perf_counter()
    plan = dryrun.plan_cell(
        cfg, ShapeSpec(f"{tag}_decode", run["T"], run["B"], "decode"),
        make_mesh(M_MESH, M_AXES, ["meta"] * M_PROCS))
    plan_s = time.perf_counter() - t0
    got, want = ranks[0]["logits"], one["logits"]
    gaps = []
    for g, w in zip(got, want):
        if g.shape != w.shape or not np.isfinite(g).all():
            fail(f"phase {tag}: sharded logits {g.shape}, finite "
                 f"{bool(np.isfinite(g).all())}; unsharded {w.shape}")
        gaps.append(float(np.abs(g - w).max() / np.abs(w).max()))
    rec = {
        "arch": run["arch"], "dtype": run["dtype"], "units": run["units"],
        "layers": cfg.n_layers, "params": cfg.param_count(),
        "mesh": dict(zip(M_AXES, M_MESH)), "backend": backend,
        "devices": [str(d) for d in devices],
        "batch": run["B"], "prompt": run["S"], "cache": run["T"],
        "decode_from": run["pos"], "decode_steps": len(got) - 1,
        "repeated_prompt_rows": run["B"] // 2 if run["repeat"] else 0,
        "image_tokens": cfg.n_image_tokens,
        "gates": I_GATE if cfg.n_image_tokens else None,
        "gap_prefill": gaps[0], "gap_decode": gaps[1:], "gap_max": max(gaps),
        "logit_scale": float(max(np.abs(w).max() for w in want)),
        "param_bytes_per_rank": [r["param_bytes"] for r in ranks],
        "plan_argument_bytes": plan["memory"]["argument_bytes"],
        "plan_argument_parts": plan["argument_parts"],
        "plan_collectives": plan["collectives"],
        "plan_collective_counts": plan.get("collective_counts"),
        "plan_s": plan_s,
        "init_peak_device_bytes_per_rank": [r["init_peak_device_bytes"]
                                            for r in ranks],
        "serving_peak_device_bytes_per_rank": [
            r["serving_peak_device_bytes"] for r in ranks],
        "init_s_per_rank": [r["init_s"] for r in ranks],
        "sharded_prefill_ms": ranks[0]["prefill_ms"],
        "sharded_decode_ms": ranks[0]["decode_ms"],
        "unsharded_prefill_ms": one["prefill_ms"],
        "unsharded_decode_ms": one["decode_ms"],
        "collectives": ranks[0]["collectives"],
        "unsharded_param_bytes": one["param_bytes"],
        "unsharded_peak_device_bytes": one["peak_device_bytes"],
        "launches": {k: sum(r["launches"].get(k, 0) for r in ranks)
                     + one["launches"].get(k, 0)
                     for k in ranks[0]["launches"]},
        "sharded_s": max(r["s"] for r in ranks),
        "unsharded_s": one["s"]}
    if one["routes"]:
        rec["moe"] = m_routing(ranks, one, moe_layers(cfg))
    return rec


def drive_sharded_serve(seed: int, card: str, tags=MN_RUNS) -> dict:
    """Phases M, N and O: the runs ``tags`` on
    ``spmd.card_layout(M_PROCS)``, all in one spawn of the ranks (their
    start-up paid once), then each unsharded in this process; each held
    to its bound (M_TOL, N_TOL, O_TOL) and
    its ranks' parameter bytes to the plan's; N2's and N3's routing to the
    unsharded run's, N2's assignments dropped alike on both sides."""
    import torch
    from repro_torch.launch import spmd

    layout = spmd.card_layout(M_PROCS)
    n_cards = torch.cuda.device_count()
    print(f"phases M, N, O: {M_PROCS} processes, backend {layout[0]}, "
          f"{n_cards} cards, devices {[str(d) for d in layout[1]]}")
    t0 = time.perf_counter()
    ranks = spmd.run(m_rank, layout[1], layout[0], (tuple(tags), seed))
    spawn_s = time.perf_counter() - t0
    out = {"backend": layout[0], "cards": n_cards, "spawn_s": spawn_s,
           "launches": {}}
    for tag in tags:
        t0 = time.perf_counter()
        one = m_unsharded(tag, seed)
        one["s"] = time.perf_counter() - t0
        r = m_readings(tag, [x[tag] for x in ranks], one, layout)
        r["s"] = r["sharded_s"] + r["unsharded_s"] + r["plan_s"]
        tol = {**M_TOL, **N_TOL, **O_TOL}[tag]
        r["tol"] = tol
        print(json.dumps({"phase": tag, **r, "card": card}))
        if r["gap_max"] > tol:
            fail(f"phase {tag}: sharded logits off the unsharded by "
                 f"{r['gap_max']:.3g} of their scale, over {tol:.3g}")
        want = r["plan_argument_parts"]["params"]
        if any(b != want for b in r["param_bytes_per_rank"]):
            fail(f"phase {tag}: ranks hold {r['param_bytes_per_rank']} "
                 f"parameter bytes, the plan {want} a position")
        m = r.get("moe")
        if tag in N_SAME_ROUTING and m["routing_differs"]:
            fail(f"phase {tag}: routing {m}: the sharded run must route "
                 "every token as the unsharded run")
        if tag in N_REPEAT and (m["dropped_sharded_prefill"] !=
                                m["dropped_unsharded_prefill"] or
                                m["dropped_unsharded_prefill"] <= 0):
            fail(f"phase {tag}: routing {m}: the sharded run must drop "
                 "as many assignments as the unsharded run, more than 0")
        if any(r["launches"].values()):
            fail(f"phase {tag}: the model path launched {r['launches']}")
        phase = tag[0]
        out[tag] = {k: r[k] for k in ("gap_max", "s", "param_bytes_per_rank")}
        if "moe" in r:
            out[tag]["moe"] = r["moe"]
        counts = out["launches"].setdefault(phase, {})
        for k, n in r["launches"].items():
            counts[k] = counts.get(k, 0) + n
    return out


# phase P: the sharded train step on M's mesh and launcher
P_ARCH = {"P1": "qwen2-0.5b", "P2": "qwen2-0.5b",
          "P3": "deepseek-v2-lite-16b", "Q1": "hymba-1.5b",
          "Q2": "xlstm-1.3b", "Q3": "llama-3.2-vision-11b"}
# (dtype, pattern units, microbatch): P1 qwen2 at full width in bf16 with
# the f32 master, 2 of its 24 layers; P2 1 layer in f32 at microbatch 2;
# P3 deepseek's dense layer and one MoE unit in f32 (N3's cut).  Every
# run remat "full", P_STEPS AdamW steps of P_B x P_S tokens.  P1's cuts:
# at full depth its steps took 17.0, 25.3 and 45.3 s (the last waiting on
# rank 0's 7 GB checkpoint, 36.9 s), its run 160 s and the fresh ranks'
# resume 54 s (on an NVIDIA H100 80GB HBM3, 700.00 W), which
# put phase P near 365 s and the smoke past 1,000 s: cut to 4 layers;
# then phase Q's ~270 s (the same card) cut P1 to 2 layers and P2 from 2
# to 1, with ``--keys`` (A_KEYS), to keep the smoke near 1,100 s
P_RUNS = {"P1": ("bfloat16", 2, 1), "P2": ("float32", 1, 2),
          "P3": ("float32", 1, 1),
          # phase Q, the recurrent and cross-attention blocks in the same
          # spawn: Q1 2 of hymba's 32 layers in bf16 with the f32 master,
          # its window as published; Q2 one of xlstm's 6 units (7 mLSTM
          # and 1 sLSTM) in f32; Q3 one of llama-3.2-vision's 8 units (4
          # attn_mlp and 1 cross_attn_mlp) in f32, its gates at I_GATE
          # and P_IMAGE's 1600 image tokens a row
          "Q1": ("bfloat16", 2, 1), "Q2": ("float32", 1, 1),
          "Q3": ("float32", 1, 1)}
P_B, P_S, P_STEPS = 8, 128, 3
P_CKPT_AFTER = 2          # P1 checkpoints after step 2; fresh ranks redo 3
P_LEAF_KINDS = ("params", "master", "m", "v")
P_STEP1_KINDS = ("m", "v")   # held after the first step (P_TOL's "step1")
# Bounds, sharded against unsharded: "metrics" on each step's loss and
# grad norm (relative), "step1" on each leaf of m and v after the first
# step (the gradient, taken while both runs route alike), "leaves" on
# each leaf of the parameters, master, m and v after the last step (both
# of the leaf's largest magnitude).  Set between readings of
# port/scripts/shard_tol_control.py --tag P1|P2|P3 on an NVIDIA H100 80GB
# HBM3, 700.00 W (sound seeds 0-2; faults on seed 0: a data rank's
# gradients unreduced, the norm over a rank's own pieces, P3's aux over a
# rank's own tokens), each bound the power of two nearest the geometric
# mean of the largest sound reading and the smallest fault reading.  P1
# (bf16, 4 layers): metrics sound <= 6.60e-4, faults >= 0.104; step1 <=
# 0.0343 against >= 1.05; leaves <= 0.0332 (bf16 parameters moved by
# Adam's per-entry normalization) against >= 0.993 (at 24 layers, before
# the cut: metrics <= 2.15e-3, leaves <= 0.0967 against >= 0.105 and >=
# 0.911).  P2 (f32): metrics <= 3.4e-7 against >= 0.0984; step1 <= 4.81e-6
# against >= 0.994; leaves <= 9.1e-4 against >= 0.99.  P3 (f32): metrics
# <= 1.20e-5 against >= 1.22e-4 (the aux over a rank's own tokens); step1
# <= 1.26e-5 against >= 0.111 (the same fault); the aux loss read equal
# (0.0) against 0.040.  P3's leaves read 0.10-0.14 (m of the experts):
# of 2,048 routings a step (the forward's and remat's recomputation's),
# 0 differ at step 1 on every seed, 2 at step 3 on every seed and 2 at
# step 2 on seed 2, each between experts whose probabilities tie to
# within 1e-5 (the median margin 2.0e-3), and such a flip moves a
# token's share of two experts' gradients; 2^-2 there holds only a
# coarse line, 1.5x under the fault at 0.367, and "step1" is P3's check
# of every gradient leaf.  See PERF.md
P_TOL = {"P1": {"metrics": 2.0 ** -7, "step1": 2.0 ** -2,
                "leaves": 2.0 ** -2},
         "P2": {"metrics": 2.0 ** -12, "step1": 2.0 ** -9,
                "leaves": 2.0 ** -5},
         "P3": {"metrics": 2.0 ** -15, "step1": 2.0 ** -10,
                "leaves": 2.0 ** -2},
         "Q1": {"metrics": 2.0 ** -9, "step1": 2.0 ** -3,
                "leaves": 2.0 ** -2},
         "Q2": {"metrics": 2.0 ** 0, "step1": 2.0 ** -2,
                "leaves": 2.0 ** 1},
         "Q3": {"metrics": 2.0 ** -18, "step1": 2.0 ** -7,
                "leaves": 2.0 ** -4}}
# Q's by the same method (shard_tol_control.py --tag Q1|Q2|Q3, the same
# card; faults also conv_w's gradient from a rank's own rows (Q1), the
# sLSTM carry one step stale (Q2), the gates' gradients left partial over
# "data" (Q3)).  Q1 (bf16, 2 layers): metrics sound <= 1.59e-4, faults >=
# 0.0140 (conv_w); step1 <= 0.0302 against >= 0.921; leaves <= 0.0821
# against >= 0.800.  Q3 (f32): metrics <= 3.33e-7 against >= 2.86e-5
# (the gates); step1 <= 5.6e-5 against >= 0.978; leaves <= 5.19e-3
# against >= 0.742.  Q2 (xlstm f32): step1 <= 0.112 against >= 1.01, the
# one line that parts them.  xlstm's runs part on their own: the run
# unsharded against itself with every parameter one ulp up on half its
# entries (shard_tol_control.py --tag Q2 --ulp, the same card) reads step1
# 0.040, 0.564, 0.011, metrics 0.147-0.312 and leaves 1.31-2.68 on seeds
# 0-2, as far as the sharding moves it; so step1 holds seed 0 (0.0170) and
# could cross on another seed.  The grad norm of steps 2-3 differs by up to
# 80% on a sound seed (0.801) against 24-46% under the faults, the leaves
# <= 1.88 sound against 1.44-4.95: no bound parts them, and metrics and
# leaves are lines at the power of two above the sound readings (a
# divergence or a NaN)
P_AUX_TOL = 2.0 ** -16    # P3's aux loss, relative
P_ONE_DEVICE = "cuda:0"   # the unsharded runs' (a CPU rehearsal: "cpu")


def p_config(tag: str):
    """Run ``tag``'s arch at full width, its pattern units, its dtype."""
    from repro_torch.configs import get_config
    dtype, units, _ = P_RUNS[tag]
    return dataclasses.replace(get_config(P_ARCH[tag]), n_units=units,
                               dtype=dtype)


def p_train(tag: str):
    from repro_torch.launch.steps import TrainConfig
    return TrainConfig(remat="full", microbatch=P_RUNS[tag][2])


def p_batches(cfg, seed: int) -> list:
    """P_STEPS batches of P_B x P_S token ids and labels from ``seed``
    (the same on both sides), and for a config with image tokens the
    image embeddings (P_B, I, D), N(0, 1) in float32 (``p_tensors`` casts
    them to bfloat16, the dry run's input spec)."""
    rng = np.random.default_rng(seed + 80)
    out = []
    for _ in range(P_STEPS):
        b = {k: rng.integers(0, cfg.vocab, (P_B, P_S)).astype(np.int32)
             for k in ("tokens", "labels")}
        if cfg.n_image_tokens:
            b["image_embed"] = rng.standard_normal(
                (P_B, cfg.n_image_tokens, cfg.d_model), dtype=np.float32)
        out.append(b)
    return out


def p_tensors(batch: dict, device) -> dict:
    """One of ``p_batches`` on ``device``, the image embeddings in
    bfloat16."""
    import torch
    return {k: torch.from_numpy(v).to(device, torch.bfloat16
                                      if k == "image_embed" else None)
            for k, v in batch.items()}


def _p_aux(model, cfg, batch, rules=None, mesh=None) -> float:
    """The aux loss of ``batch`` at ``model``'s parameters."""
    import torch
    from repro_torch.launch.sharding import rules_ctx
    from repro_torch.models import loss_fn

    with rules_ctx(rules, mesh), torch.no_grad():
        aux = loss_fn(model, cfg, batch, remat="none")[1]["aux"]
    return float(aux.full_tensor() if hasattr(aux, "full_tensor") else aux)


def p_unsharded(tag: str, seed: int, out_dir: str) -> dict:
    """Run ``tag`` on one process on P_ONE_DEVICE from the same draw as
    the ranks' (``m_leaves``): P_STEPS train steps, each timed, every MoE
    routing watched (``route_calls``: the calls made by the end of each
    step); AdamW's m and v after the first step and the state after the
    last saved to ``out_dir`` (``ckpt.save``'s layout, for the ranks to
    read; a float32 run's master, equal to its parameters bit for bit, is
    not written twice); the aux loss of the first batch before any
    step."""
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import Model, param_shapes
    from repro_torch.models.layers import tree_unflatten
    from repro_torch.optim import adamw_init

    cfg, tc = p_config(tag), p_train(tag)
    dev = torch.device(P_ONE_DEVICE)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = Model(cfg, tree_unflatten(param_shapes(cfg), [
        t for _, t in m_leaves(cfg, gen, str(dev))])).trainable()
    opt = adamw_init(model, tc.optim)
    batches = [p_tensors(b, dev) for b in p_batches(cfg, seed)]
    rec = {"aux": _p_aux(model, cfg, batches[0]) if cfg.n_experts else None}
    step = build_train_step(cfg, tc)
    rec["loss"], rec["grad_norm"], rec["step_ms"] = [], [], []
    rec["route_calls"] = []
    with RouteWatch() as routes:
        for i, b in enumerate(batches):
            (model, opt, m), t = _m_timed(lambda: step(model, opt, b))
            rec["loss"].append(float(m["loss"]))
            rec["grad_norm"].append(float(m["grad_norm"]))
            rec["step_ms"].append(t)
            rec["route_calls"].append(len(routes.calls))
            if i == 0:
                ckpt.save({"o": {k: opt[k] for k in P_STEP1_KINDS}},
                          out_dir, 1)
    rec["routes"] = routes.host()
    rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    if cfg.dtype == "float32":
        opt = {k: v for k, v in opt.items() if k != "master"}
    ckpt.save({"p": model.tree(), "o": opt}, out_dir, P_STEPS)
    del model, opt, batches
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _p_digest(tree) -> dict:
    """Each leaf's local piece (a DTensor's, or the tensor) as a digest of
    its bytes: held bit for bit between two runs of the same ranks."""
    import hashlib
    import torch
    from repro_torch.models.layers import tree_paths

    out = {}
    for name, t in tree_paths(tree):
        t = t.to_local() if hasattr(t, "to_local") else t
        t = t.detach().contiguous().cpu()
        raw = t.view(torch.uint8) if t.dim() else t.reshape(1).view(
            torch.uint8)
        out[name] = hashlib.sha256(raw.numpy().tobytes()).hexdigest()
    return out


def _p_gaps(tree, ref_dir: str, mesh, step: int = P_STEPS,
            kinds: tuple = P_LEAF_KINDS) -> dict:
    """The largest gap of each of ``kinds`` of leaf (of P_LEAF_KINDS)
    between the ranks' state ``tree`` ({"p", "o"}) and the unsharded run's
    state after ``step`` in ``ref_dir``, as a share of each leaf's largest
    magnitude: each rank reads its pieces of the unsharded leaves, and the
    gaps and the scales are reduced by max over the mesh."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.ckpt import _load
    from repro_torch.launch.sharding import local_shard
    from repro_torch.models.layers import tree_paths

    def piece(meta, t):
        whole = _load(pathlib.Path(d) / meta["file"], meta["dtype"],
                      mmap=True)
        return local_shard(whole, _spec_of(t, mesh), mesh).to(
            t.device, torch.float32)

    d = os.path.join(ref_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    trees = {"params": tree.get("p"), **{k: tree["o"].get(k) for k in
                                         ("master", "m", "v")}}
    names, rows = [], []
    for kind in kinds:
        prefix = "p." if kind == "params" else f"o.{kind}."
        for name, t in tree_paths(trees[kind]):
            # a float32 run's master is its parameters (not written twice)
            meta = leaves.get(prefix + name) or leaves["p." + name]
            want = piece(meta, t)
            got = t.to_local().float()
            rows.append(torch.stack([(got - want).abs().max(),
                                     want.abs().max()]))
            names.append(kind)
    both = torch.stack(rows)
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    out = {k: 0.0 for k in kinds}
    for kind, (gap, scale) in zip(names, both.tolist()):
        out[kind] = max(out[kind], gap / scale if scale else gap)
    return out


def _spec_of(t, mesh):
    """The spec whose placements on ``mesh`` are the DTensor ``t``'s."""
    from repro_torch.launch.sharding import P
    parts = [[] for _ in range(t.ndim)]
    for axis, pl in zip(mesh.axis_names, t.placements):
        if pl.is_shard():
            parts[pl.dim].append(axis)
    return P(*(tuple(p) for p in parts))


def p_rank(rank: int, device, tags: tuple, seed: int, ref_root: str,
           ckpt_dir: str | None, patch=None, keep: bool = False) -> dict:
    """One rank of phases P and Q, each run of ``tags`` in turn: rank 0
    first runs it unsharded (``p_unsharded``, its state written under
    ``ref_root``, unless an earlier spawn wrote it there), the other ranks
    waiting, so that one run's reference is on disk at a time and no model
    but the ranks' is on the card while they run; then ``patch()`` (a
    control's fault, once; None: none), and ``p_config``'s model laid out
    over the process mesh under DEFAULT_RULES, drawn leaf by leaf with
    ``m_leaves`` on a generator seeded ``seed`` (the unsharded run's
    draws), its AdamW state laid out as the parameters; P_STEPS train
    steps, each timed, every MoE routing watched, the first under
    ``plan.ShardMeter`` (the collectives of a step by kind, and their
    bytes, and ``SlstmLoopMeter``'s count of those inside the sLSTM's time
    loop), m and v after it held against the unsharded run's; P1
    checkpoints after step P_CKPT_AFTER into ``ckpt_dir`` (None: it does
    not).  Then the gaps to the unsharded run's state, for P1 each leaf's
    digest, and the reference removed (unless ``keep``).  Returns a record
    a run, rank 0's with the unsharded run's as ``one``."""
    import pickle
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import ckpt
    from repro_torch.convert import shard_params
    from repro_torch.kernels import ops
    from repro_torch.launch.inputs import shard_batch
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.plan import ShardMeter
    from repro_torch.launch.sharding import DEFAULT_RULES, ShardingRules
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import adamw_init

    mesh = make_process_mesh(M_MESH, M_AXES, device)
    rules = ShardingRules(DEFAULT_RULES)
    out = {}
    for tag in tags:
        ref = os.path.join(ref_root, tag)
        saved = os.path.join(ref, "unsharded.pkl")
        if rank == 0 and not os.path.exists(saved):
            t0 = time.perf_counter()
            one = p_unsharded(tag, seed, ref)
            one["s"] = time.perf_counter() - t0
            with open(saved, "wb") as f:
                pickle.dump(one, f)
        dist.barrier()
        if patch is not None:
            patch()
            patch = None
        t_run = time.perf_counter()
        cfg, tc = p_config(tag), p_train(tag)
        torch.cuda.reset_peak_memory_stats(device)
        ops.reset_launches()
        gen = torch.Generator(device=device).manual_seed(seed)
        model = shard_params(m_leaves(cfg, gen, device), mesh, rules,
                             cfg).trainable()
        opt = adamw_init(model, tc.optim)
        batches = [shard_batch(p_tensors(b, device), mesh)
                   for b in p_batches(cfg, seed)]
        rec = {"aux": _p_aux(model, cfg, batches[0], rules, mesh)
               if cfg.n_experts else None}
        step = build_train_step(cfg, tc, rules, mesh)
        rec["loss"], rec["grad_norm"], rec["step_ms"] = [], [], []
        rec["route_calls"] = []
        with RouteWatch() as routes, SlstmLoopMeter() as loop:
            for i, b in enumerate(batches):
                meter = ShardMeter() if i == 0 else contextlib.nullcontext()
                loop.meter = meter if i == 0 else None

                def one_step():
                    with meter:
                        return step(model, opt, b)
                (model, opt, m), t = _m_timed(one_step, dist.barrier)
                rec["loss"].append(float(m["loss"]))
                rec["grad_norm"].append(float(m["grad_norm"]))
                rec["step_ms"].append(t)
                rec["route_calls"].append(len(routes.calls))
                if i == 0:
                    rec["collectives_step"] = meter.counts
                    rec["collective_bytes_step"] = meter.collectives
                    # m and v after one step are the gradient's, taken
                    # where both runs route alike
                    rec["gaps_step1"] = _p_gaps({"o": opt}, ref, mesh, 1,
                                                P_STEP1_KINDS)
                if tag == "P1" and ckpt_dir and i + 1 == P_CKPT_AFTER:
                    t0 = time.perf_counter()
                    ckpt.save({"p": model.tree(), "o": opt}, ckpt_dir,
                              P_CKPT_AFTER)
                    rec["ckpt_s"] = time.perf_counter() - t0
        rec["routes"] = routes.host()
        rec["by_tokens"] = len(routes.by_tokens)
        rec["slstm_loop"] = {"collectives": loop.counts,
                             "tokens": loop.tokens, "loops": loop.loops,
                             "backwards": loop.backwards}
        rec["coordinate"] = list(mesh.coordinate)
        state = {"p": model.tree(), "o": opt}
        rec["gaps"] = _p_gaps(state, ref, mesh)
        if tag == "P1":                  # held against the resumed step
            rec["digest"] = _p_digest(state)
        rec["param_bytes"] = sum(t.to_local().numel()
                                 * t.to_local().element_size()
                                 for t in model.parameters())
        rec["opt_bytes"] = sum(
            t.to_local().numel() * t.to_local().element_size()
            for k in ("m", "v", "master") for t in tree_leaves(opt[k]))
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
        rec["launches"] = dict(ops.launches)
        del model, opt, state, batches
        gc.collect()
        torch.cuda.empty_cache()     # the next run's ranks share the card
        rec["s"] = time.perf_counter() - t_run
        dist.barrier()               # every rank has read the reference
        if rank == 0:
            with open(saved, "rb") as f:
                rec["one"] = pickle.load(f)
            if not keep:
                shutil.rmtree(ref, ignore_errors=True)
        out[tag] = rec
    return out


def p_resume_rank(rank: int, device, seed: int, ckpt_dir: str) -> dict:
    """Fresh ranks of run P1: the model and AdamW state restored from the
    checkpoint written after step P_CKPT_AFTER (each rank reading its
    pieces), then step P_CKPT_AFTER + 1; its loss, grad norm and every
    leaf's digest."""
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch.inputs import shard_batch
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.sharding import (DEFAULT_RULES, ShardingRules,
                                             distribute, param_sharding)
    from repro_torch.launch.steps import build_train_step, opt_state_specs
    from repro_torch.models import Model, param_shapes
    from repro_torch.models.layers import tree_map

    mesh = make_process_mesh(M_MESH, M_AXES, device)
    rules = ShardingRules(DEFAULT_RULES)
    cfg, tc = p_config("P1"), p_train("P1")
    specs = {"p": param_sharding(mesh, rules, param_shapes(cfg)),
             "o": opt_state_specs(cfg, mesh, rules, tc)}

    def empty(s):
        if not s.shape:                    # the AdamW step: a plain scalar
            return torch.zeros((), dtype=s.dtype, device=device)
        return distribute(s.meta(), s.spec, mesh, local=torch.empty(
            s.shard_shape(), dtype=s.dtype, device=device))
    t0 = time.perf_counter()
    state, at = ckpt.restore(tree_map(empty, specs), ckpt_dir, P_CKPT_AFTER,
                             specs)
    restore_s = time.perf_counter() - t0
    model = Model(cfg, state["p"]).trainable()
    opt = state["o"]
    b = p_batches(cfg, seed)[P_CKPT_AFTER]
    batch = shard_batch({k: torch.from_numpy(v).to(device)
                         for k, v in b.items()}, mesh)
    model, opt, m = build_train_step(cfg, tc, rules, mesh)(model, opt, batch)
    return {"at": at, "restore_s": restore_s, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]),
            "digest": _p_digest({"p": model.tree(), "o": opt})}


def p_plan_bytes(cfg, tag: str) -> dict:
    """The plan's parameter and optimizer bytes a position of the (2, 2)
    mesh (``dryrun.plan_cell``'s ``argument_parts``: the shard shapes of
    the specs)."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.launch.inputs import param_specs_sharded
    from repro_torch.launch.plan import tree_bytes
    from repro_torch.launch.sharding import DEFAULT_RULES, ShardingRules
    from repro_torch.launch.steps import opt_state_specs

    mesh = make_mesh(M_MESH, M_AXES, ["meta"] * M_PROCS)
    rules = ShardingRules(DEFAULT_RULES)
    ospec = opt_state_specs(cfg, mesh, rules, p_train(tag))
    return {"params": tree_bytes(param_specs_sharded(cfg, mesh, rules)),
            "optimizer": tree_bytes({k: v for k, v in ospec.items()
                                     if k != "step"})}


def p_readings(tag: str, ranks: list, one: dict) -> dict:
    """One run of phase P: the gaps, both runs' times, the ranks' bytes
    beside the plan's, and for P3 the aux loss both ways and the byte
    rule's sides."""
    cfg = p_config(tag)
    r0 = ranks[0]

    def rel(a, b):
        return abs(a - b) / abs(b) if b else abs(a - b)
    for r in ranks:
        if not np.isfinite(r["loss"] + r["grad_norm"]).all():
            fail(f"phase {tag}: loss {r['loss']} or grad norm "
                 f"{r['grad_norm']} not finite")
    gaps = {"loss": max(rel(a, b) for a, b in zip(r0["loss"], one["loss"])),
            "grad_norm": max(rel(a, b) for a, b in zip(r0["grad_norm"],
                                                        one["grad_norm"]))}
    plan = p_plan_bytes(cfg, tag)
    rec = {
        "arch": P_ARCH[tag], "dtype": cfg.dtype, "units": cfg.n_units,
        "layers": cfg.n_layers, "params": cfg.param_count(),
        "microbatch": P_RUNS[tag][2], "remat": "full",
        "mesh": dict(zip(M_AXES, M_MESH)), "batch": P_B, "seq": P_S,
        "steps": P_STEPS,
        "loss_sharded": r0["loss"], "loss_unsharded": one["loss"],
        "grad_norm_sharded": r0["grad_norm"],
        "grad_norm_unsharded": one["grad_norm"],
        "gap_metrics": max(gaps.values()), "gap_loss": gaps["loss"],
        "gap_grad_norm": gaps["grad_norm"],
        "gap_step1": r0["gaps_step1"],
        "gap_step1_max": max(r0["gaps_step1"].values()),
        "gap_leaves": r0["gaps"], "gap_leaves_max": max(r0["gaps"].values()),
        "collectives_step": r0["collectives_step"],
        "collective_bytes_step": r0["collective_bytes_step"],
        "sharded_step_ms": r0["step_ms"], "unsharded_step_ms": one["step_ms"],
        "peak_device_bytes_per_rank": [r["peak_device_bytes"]
                                       for r in ranks],
        "unsharded_peak_device_bytes": one["peak_device_bytes"],
        "param_bytes_per_rank": [r["param_bytes"] for r in ranks],
        "opt_bytes_per_rank": [r["opt_bytes"] for r in ranks],
        "plan_param_bytes": plan["params"],
        "plan_opt_bytes": plan["optimizer"],
        "launches": {k: sum(r["launches"].get(k, 0) for r in ranks)
                     for k in r0["launches"]},
        "sharded_s": max(r["s"] for r in ranks), "unsharded_s": one["s"]}
    if cfg.n_image_tokens:
        rec["image_tokens"], rec["gate"] = cfg.n_image_tokens, I_GATE
    if r0["slstm_loop"]["loops"]:
        # the first step's loops (forward, recomputed forward, backward)
        loop = dict(r0["slstm_loop"])
        loop["collectives_a_token"] = sum(loop["collectives"].values()) / \
            loop["tokens"]
        rec["slstm_loop"] = loop
    if cfg.n_experts:
        rec["aux_sharded"], rec["aux_unsharded"] = r0["aux"], one["aux"]
        rec["gap_aux"] = rel(r0["aux"], one["aux"])
        rec["moe_calls"] = len(r0["routes"])
        rec["moe_by_tokens"] = r0["by_tokens"]
        rec["moe_weights_gathered"] = len(r0["routes"]) - r0["by_tokens"]
        rec["routing"] = p_routing(ranks, one)
    return rec


def p_routing(ranks: list, one: dict) -> dict:
    """The sharded run's routing beside the unsharded run's, step by step:
    the tokens of a step's MoE calls (its forward's and remat's
    recomputation's) whose top-k experts differ, the tokens routed, and
    the unsharded run's largest k-th-less-next margin among those that
    differ, beside the median margin of every token.  The sharded side's
    tokens are the data ranks' in order, read on model rank 0."""
    lead = sorted((r for r in ranks if r["coordinate"][1] == 0),
                  key=lambda r: r["coordinate"][0])
    if any(r["route_calls"] != one["route_calls"] for r in lead):
        fail(f"MoE calls a step {lead[0]['route_calls']} sharded, "
             f"{one['route_calls']} unsharded")
    out = {"routing_differs_by_step": [], "routings_by_step": [],
           "flip_margin_max_by_step": []}
    start = 0
    for end in one["route_calls"]:
        differs, routed, flipped = 0, 0, []
        for c in range(start, end):
            a = np.concatenate([r["routes"][c][0] for r in lead])
            b, _, margin = one["routes"][c]
            if a.shape != b.shape:
                fail(f"routing of {a.shape} tokens sharded, {b.shape} "
                     "unsharded")
            d = (a != b).any(axis=-1)
            differs += int(d.sum())
            routed += a.shape[0]
            flipped.append(margin[d])
        flipped = np.concatenate(flipped) if flipped else np.zeros(0)
        out["routing_differs_by_step"].append(differs)
        out["routings_by_step"].append(routed)
        out["flip_margin_max_by_step"].append(
            float(flipped.max()) if flipped.size else None)
        start = end
    out["margin_median"] = float(np.median(np.concatenate(
        [r[2] for r in one["routes"]])))
    return out


P_TAGS = tuple(P_RUNS)


def drive_sharded_train(seed: int, card: str, tags=P_TAGS) -> dict:
    """Phases P and Q: every run of ``tags`` on ``spmd.card_layout(M_PROCS)``
    in one spawn, each run first unsharded on cuda:0 by rank 0
    (``p_rank``), then P1's checkpoint restored by fresh ranks whose step
    P_CKPT_AFTER + 1 must equal the first ranks' bit for bit.  Each run
    held to its bounds (P_TOL; P3's aux loss to P_AUX_TOL, nonzero), its
    ranks' parameter and optimizer bytes to the plan's, Q2's sLSTM loop to
    no collective."""
    from repro_torch.launch import spmd

    layout = spmd.card_layout(M_PROCS)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p_")
    try:
        ckpt_dir = os.path.join(tmp, "ckpt")
        print(f"phases P and Q: {M_PROCS} processes, backend {layout[0]}, "
              f"devices {[str(d) for d in layout[1]]}")
        t0 = time.perf_counter()
        ranks = spmd.run(p_rank, layout[1], layout[0],
                         (tuple(tags), seed, os.path.join(tmp, "refs"),
                          ckpt_dir))
        spawn_s = time.perf_counter() - t0
        resumed = None
        if "P1" in tags:
            t0 = time.perf_counter()
            resumed = spmd.run(p_resume_rank, layout[1], layout[0],
                               (seed, ckpt_dir))
            resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"backend": layout[0], "spawn_s": spawn_s,
           "launches": {"P": {}, "Q": {}}}
    for tag in tags:
        r = p_readings(tag, [x[tag] for x in ranks], ranks[0][tag]["one"])
        tol = P_TOL[tag]
        r["tol"] = tol
        if tag == "P1":
            first = [x["P1"]["digest"] for x in ranks]
            r["resume"] = {
                "at": resumed[0]["at"], "restore_s": resumed[0]["restore_s"],
                "s": resume_s, "ckpt_s": ranks[0]["P1"]["ckpt_s"],
                "loss": resumed[0]["loss"],
                "grad_norm": resumed[0]["grad_norm"],
                "bit_equal": all(a["digest"] == b for a, b in
                                 zip(resumed, first)) and
                resumed[0]["loss"] == r["loss_sharded"][-1] and
                resumed[0]["grad_norm"] == r["grad_norm_sharded"][-1]}
        print(json.dumps({"phase": tag, **r, "card": card}))
        if r["gap_metrics"] > tol["metrics"]:
            fail(f"phase {tag}: loss or grad norm off the unsharded run's "
                 f"by {r['gap_metrics']:.3g}, over {tol['metrics']:.3g}")
        if r["gap_step1_max"] > tol["step1"]:
            fail(f"phase {tag}: m or v after step 1 off the unsharded "
                 f"run's by {r['gap_step1']}, over {tol['step1']:.3g}")
        if r["gap_leaves_max"] > tol["leaves"]:
            fail(f"phase {tag}: state off the unsharded run's by "
                 f"{r['gap_leaves']}, over {tol['leaves']:.3g}")
        if tag == "P1" and not r["resume"]["bit_equal"]:
            fail(f"phase P1: the resumed step {P_CKPT_AFTER + 1} differs "
                 f"from the uninterrupted one: {r['resume']}")
        if "gap_aux" in r and (r["gap_aux"] > P_AUX_TOL or
                               not r["aux_sharded"] > 0):
            fail(f"phase {tag}: aux loss {r['aux_sharded']} sharded, "
                 f"{r['aux_unsharded']} unsharded, over {P_AUX_TOL:.3g}")
        if any(b != r["plan_param_bytes"] for b in r["param_bytes_per_rank"]) \
                or any(b != r["plan_opt_bytes"]
                       for b in r["opt_bytes_per_rank"]):
            fail(f"phase {tag}: ranks hold {r['param_bytes_per_rank']} "
                 f"parameter and {r['opt_bytes_per_rank']} optimizer "
                 f"bytes, the plan {r['plan_param_bytes']} and "
                 f"{r['plan_opt_bytes']} a position")
        if "slstm_loop" in r and (r["slstm_loop"]["collectives"] or
                                  not r["slstm_loop"]["backwards"]):
            fail(f"phase {tag}: the sLSTM's time loop issued collectives "
                 f"in step 1: {r['slstm_loop']}")
        if any(r["launches"].values()):
            fail(f"phase {tag}: the train path launched {r['launches']}")
        out[tag] = {k: r[k] for k in ("gap_metrics", "gap_step1_max",
                                      "gap_leaves_max", "sharded_s",
                                      "unsharded_s")}
        counts = out["launches"][tag[0]]
        for k, n in r["launches"].items():
            counts[k] = counts.get(k, 0) + n
    return out


# ----------------------------------------------------------------------------
# the correctness gates (phase R)
# ----------------------------------------------------------------------------

# each gate at the reference's size, then at one the default LSMConfig
# spreads over L1 and L2 (R1) or over two L1 files a shard (R2); shrink
# the second sizes first (2^19, 2^17) if the run nears its limit
R_GATES = {"R1": ("check_filter_zero_fn", (1 << 12, 1 << 20)),
           "R2": ("check_io_determinism", (1 << 12, 1 << 18))}


def _gate(script: str):
    """``port/scripts/<script>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        script, os.path.join(HERE, "port", "scripts", script + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class EngineCapture(_Patch):
    """Keeps, while installed on a ``BourbonStore``'s engine, the padded
    probes of every lookup the store dispatches to the device."""

    def __init__(self, engine):
        super().__init__(engine, "lookup_async")
        self.sets = []

    def wrap(self, orig):
        def captured(state, probes, *args, **kw):
            self.sets.append(np.array(probes, np.int64))
            return orig(state, probes, *args, **kw)
        return captured


@contextlib.contextmanager
def uncounted():
    """Kernel launches inside leave the launch counts as they were."""
    from repro_torch.kernels import ops
    kept = dict(ops.launches)
    try:
        yield
    finally:
        ops.launches.update(kept)


def gate_watch(tag: str, checks: dict):
    """The ``watch`` a gate holds around each arm's GETs: capture the
    probes the arm's store dispatches, then, before the store closes, hold
    the kernels against their plain versions on them (R1 every level of
    the store's device state, ``session_shape_checks``; R2 the stacked
    shard state, ``served_shape_checks``), merged into ``checks``."""
    @contextlib.contextmanager
    def watch(arm, st):
        cap = EngineCapture(st.engine) if tag == "R1" else DispatchCapture(st)
        with cap:
            yield
        if cap.sets:
            with uncounted():
                _merge(checks, session_shape_checks(st, cap.sets)
                       if tag == "R1" else served_shape_checks(st, cap.sets))
    return watch


def drive_gates(card: str, device: str = "cuda") -> dict:
    """Phase R: ``port/scripts/check_filter_zero_fn.py`` (R1) and
    ``check_io_determinism.py`` (R2) in process on ``device``, each at the
    sizes of R_GATES.  Counts are zeroed just before each and read just
    after; the kernels are then held against their plain versions on the
    probes each arm dispatched.  Prints one line a gate; fails on a gate's
    non-zero status, when a gate launched none of the four descent
    kernels, or on a mismatch.  Returns per gate its launches and
    checks."""
    from repro_torch.kernels import ops
    out = {}
    for tag, (script, sizes) in R_GATES.items():
        mod = _gate(script)
        checks: dict = {}
        runs = []
        ops.reset_launches()
        t0 = time.perf_counter()
        for n in sizes:
            t1 = time.perf_counter()
            rc, rec = mod.gate(device, n, watch=gate_watch(tag, checks))
            del rec["answers"], rec["device"]
            runs.append(dict(rec, rc=rc, s=time.perf_counter() - t1))
            if rc != 0:
                break
        launches = dict(ops.launches)
        line = {"phase": tag, "gate": f"port/scripts/{script}.py",
                "runs": runs, "launches": launches, "checks": checks,
                "s": time.perf_counter() - t0, "card": card}
        print(json.dumps(line))
        for r in runs:
            if r["rc"] != 0:
                fail(f"phase {tag}: {script}.py --keys {r['keys']} returned "
                     f"{r['rc']} on {device}")
        if not any(launches[k] for k in KERNELS[:4]):
            fail(f"phase {tag}: the gate launched none of the descent "
                 f"kernels ({launches})")
        for name, c in checks.items():
            if c["mismatches"]:
                fail(f"phase {tag}: {name} disagrees with its plain version "
                     f"on {c['mismatches']} outputs of the gate's probes")
        out[tag] = {"launches": launches, "checks": checks}
    return out


KERNELS = ("plr_lookup", "bounded_search", "bloom_probe", "sstable_search",
           "bloom_probe_stack")
GROUP_MACROS = {"bounded_search": "BOUNDED_SEARCH_GROUP",
                "plr_lookup": "PLR_LOOKUP_GROUP",
                "sstable_search": "SSTABLE_SEARCH_GROUP"}
STACK_GROUP_MACRO = "BLOOM_PROBE_STACK_GROUP"


def _symbol(name: str) -> str:
    """The profiler's name of kernel ``name``'s CUDA function."""
    return ("bloom_probe_stack_kernel" if name == "bloom_probe_stack"
            else f"{name}_rows_kernel")


def _steps(n):
    """Bisect steps over a range of n entries, elementwise."""
    import torch
    return torch.ceil(torch.log2(n.to(torch.float64) + 1)).to(torch.int64)


def _compare(kern, plain, n: int = TIMED_BATCHES) -> tuple[int, float]:
    """Outputs that differ, and the largest difference, of ``kern`` against
    ``plain`` over the ``n`` probe sets."""
    import torch
    mism = 0
    err = 0.0
    for i in range(n):
        got, want = kern(i), plain(i)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            d = (g.long() - w.long()).abs()
            mism += int((d != 0).sum())
            err = max(err, float(d.max()))
    torch.cuda.synchronize()
    return mism, err


def _measure(kern, plain, work, symbol: str) -> dict:
    """``kern`` against ``plain`` over every probe set, both timed, and the
    bound from ``work(i)`` = (bytes, operations) probe set i needs."""
    mism, err = _compare(kern, plain)
    rec = {"mismatches": mism, "max_abs_err": err, "ms": _time(kern),
           "plain_ms": _time(plain), "device_ms": _device_ms(kern, symbol)}
    w = [work(i) for i in range(TIMED_BATCHES)]
    b = sum(x for x, _ in w) / TIMED_BATCHES
    o = sum(y for _, y in w) / TIMED_BATCHES
    bound_b = b / HBM_BYTES_PER_S * 1e3
    bound_o = o / NONTENSOR_OPS_PER_S * 1e3
    return {**rec, "bound_ms": max(bound_b, bound_o),
            "bound_by": "bytes" if bound_b >= bound_o else "operations",
            "bytes_per_launch": b, "ops_per_launch": o}


def _plr_work(tables, sets):
    """Bytes and operations a bisect over probe set i's segment tables
    needs: each probe's key, row, nseg, n and output (24 B) and its
    ceil(log2(nseg+1)) starts, slope and intercept (8 B each)."""
    starts, nseg = tables[0], tables[3]

    def work(i):
        st = _steps(nseg[sets[i][0].long()].clamp(1, starts.shape[1]))
        return int((24 + 8 * (st + 2)).sum()), int((4 * st + 4).sum())
    return work


def _bounded_work(keys, sets, delta: int):
    """Bytes and operations ``bounded_search`` over ``keys`` (F, C) needs
    on probe set i = (rows, probes, pos): each probe's key, row, n, pos
    and outputs, and the window's keys up to the first match (the whole
    window on a miss), 8 B each; three operations a key read."""
    import torch

    def work(i):
        rows, p, pos = sets[i]
        C = keys.shape[1]
        offs = torch.arange(-(delta + 1), delta + 2, device=p.device)
        win = (pos.long()[:, None] + offs).clamp(0, C - 1)
        eq = keys[rows.long()[:, None], win] == p[:, None]
        read = torch.where(eq.any(1), eq.to(torch.uint8).argmax(1) + 1,
                           2 * delta + 3)
        return (int((8 + 4 + 4 + 4 + 4 + 1 + 8 * read).sum()),
                int((3 * read + 2).sum()))
    return work


def _distinct_plr_work(tables, sets):
    """Bytes and operations ``plr_lookup`` needs on probe set i when many
    probes share a table, as at the store shape (every probe on one row):
    each probe's key, row and output (16 B), and each table entry once a
    launch however many probes read it — the starts on any probe's bisect
    path, the slope and intercept of each segment chosen, nseg and n of
    each row used (8 B each, 4 for nseg and n); the operations of
    :func:`_plr_work`."""
    import torch
    starts, slopes, icepts, nseg, n = tables
    ops_of = _plr_work(tables, sets)

    def work(i):
        rows, p = sets[i][0].long(), sets[i][1].to(torch.float64)
        F, S = starts.shape
        read = torch.zeros(F * S, dtype=torch.bool, device=p.device)
        lo = torch.zeros_like(rows)
        hi = nseg[rows].long().clamp(1, S)
        while bool((lo < hi).any()):
            act = lo < hi
            mid = (lo + hi) >> 1
            read[(rows * S + mid)[act]] = True
            right = starts[rows, mid.clamp(max=S - 1)] <= p
            lo = torch.where(act & right, mid + 1, lo)
            hi = torch.where(act & ~right, mid, hi)
        seg = (lo - 1).clamp(min=0)
        used = torch.unique(rows * S + seg).numel()
        n_rows = torch.unique(rows).numel()
        return (16 * rows.numel() + 8 * int(read.sum()) + 16 * used
                + 8 * n_rows, ops_of(i)[1])
    return work


def _distinct_bounded_work(keys, sets, delta: int):
    """Bytes and operations ``bounded_search`` over ``keys`` (F, C) needs
    on probe set i = (rows, probes, pos) when windows overlap, as at the
    store shape (every probe on one row, most clamped to its ends): each
    probe's key, row, pos and outputs (21 B), n of each row used (4 B),
    and each key once a launch that any probe's window reads up to its
    first match (the whole window on a miss); the operations of
    :func:`_bounded_work`."""
    import torch
    ops_of = _bounded_work(keys, sets, delta)

    def work(i):
        rows, p, pos = sets[i]
        F, C = keys.shape
        r = rows.long()
        offs = torch.arange(-(delta + 1), delta + 2, device=p.device)
        win = (pos.long()[:, None] + offs).clamp(0, C - 1)
        eq = keys[r[:, None], win] == p[:, None]
        upto = torch.where(eq.any(1), eq.to(torch.uint8).argmax(1),
                           2 * delta + 2)
        need = torch.arange(2 * delta + 3, device=p.device) <= upto[:, None]
        read = torch.zeros(F * C, dtype=torch.bool, device=p.device)
        read[(r[:, None] * C + win)[need]] = True
        n_rows = torch.unique(r).numel()
        return (21 * r.numel() + 4 * n_rows + 8 * int(read.sum()),
                ops_of(i)[1])
    return work


def _stack_work(bits, nw, sets, k: int):
    """Bytes and operations the stack probe over (``bits``, ``nw``) needs
    on probe set i (a probe tensor): each probe read once (8 B), nw (4 B a
    row), and per (row, probe) of a row with a filter the words up to the
    first clear bit (8 B each; the kernel reads all k, a data-dependent
    early exit needs no more), one output byte per (row, probe); ~10
    64-bit operations of hashing a probe and ~6 per word."""
    import torch
    from repro_torch.kernels import ref

    def work(i):
        hits = ref.bloom_probe_stack_hits(bits, nw, sets[i], k).long()
        # hash t's word is needed only while every earlier hash's bit is
        # set
        reached = torch.cat([torch.ones_like(hits[:1]),
                             hits.cumprod(0)[:-1]])
        n_words = int((reached * (nw > 0).long()[None, :, None]).sum())
        L, B = bits.shape[0], sets[i].shape[0]
        return 8 * B + 4 * L + 8 * n_words + L * B, 10 * B + 6 * n_words
    return work


def _plr_fns(tables, sets):
    """``plr_lookup`` over ``tables`` = (starts, slopes, icepts, nseg, n)
    on probe set i = (rows, probes, ...): (its wrapper, its plain
    version)."""
    from repro_torch.kernels import ops, ref
    return (lambda i: ops.plr_lookup(*tables, sets[i][0], sets[i][1]),
            lambda i: ref.plr_lookup_rows_ref(*tables, sets[i][0],
                                              sets[i][1]))


def _bounded_fns(lv, sets, delta: int):
    """``bounded_search`` at ``delta`` on probe set i: (its wrapper, its
    plain version)."""
    from repro_torch.kernels import ops, ref
    return (lambda i: ops.bounded_search(lv.keys, lv.n, sets[i][0],
                                         sets[i][2], sets[i][1], delta),
            lambda i: ref.bounded_search_rows_ref(lv.keys, lv.n, sets[i][0],
                                                  sets[i][2], sets[i][1],
                                                  delta))


def _bloom_fns(lv, sets, k: int):
    """``bloom_probe`` with ``k`` hashes on probe set i: (its wrapper, its
    plain version)."""
    from repro_torch.kernels import ops, ref
    return (lambda i: ops.bloom_probe(lv.bloom, lv.bloom_nw, sets[i][0],
                                      sets[i][1], k),
            lambda i: ref.bloom_probe_rows_ref(lv.bloom, lv.bloom_nw,
                                               sets[i][0], sets[i][1], k))


def _sstable_fns(lv, sets, R: int):
    """``sstable_search`` with blocks of ``R`` on probe set i: (its
    wrapper, its plain version)."""
    from repro_torch.kernels import ops, ref
    return (lambda i: ops.sstable_search(lv.fences, lv.keys, lv.n_blocks,
                                         lv.n, sets[i][0], sets[i][1], R),
            lambda i: ref.sstable_search_rows_ref(lv.fences, lv.keys,
                                                  lv.n_blocks, lv.n,
                                                  sets[i][0], sets[i][1], R))


# raw launches of a library's C entry points on the current stream, for
# comparing builds (no launch count: these are not the main path)

def _raw(fn, *args) -> None:
    import torch
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        fail(f"variant launch failed: cudaError {err}")


def _out(B: int, dtype, dev):
    import torch
    return torch.empty(B, dtype=dtype, device=dev)


def _raw_plr(lib, tables, s):
    import torch
    rows, p = s[0], s[1]
    pos = _out(p.shape[0], torch.int32, p.device)
    _raw(lib.plr_lookup_rows, *(t.data_ptr() for t in tables),
         rows.data_ptr(), p.data_ptr(), pos.data_ptr(), p.shape[0],
         tables[0].shape[1])
    return pos


def _raw_bounded(lib, lv, s, delta: int):
    import torch
    rows, p, pos = s
    idx = _out(p.shape[0], torch.int32, p.device)
    found = _out(p.shape[0], torch.bool, p.device)
    _raw(lib.bounded_search_rows, lv.keys.data_ptr(), lv.n.data_ptr(),
         rows.data_ptr(), pos.data_ptr(), p.data_ptr(), idx.data_ptr(),
         found.data_ptr(), p.shape[0], lv.keys.shape[1], delta)
    return idx, found


def _raw_bloom(lib, lv, s, k: int):
    import torch
    rows, p = s[0], s[1]
    maybe = _out(p.shape[0], torch.bool, p.device)
    _raw(lib.bloom_probe_rows, lv.bloom.data_ptr(), lv.bloom_nw.data_ptr(),
         rows.data_ptr(), p.data_ptr(), maybe.data_ptr(), p.shape[0],
         lv.bloom.shape[1], k)
    return maybe


def _raw_sstable(lib, lv, s, R: int):
    import torch
    rows, p = s[0], s[1]
    idx = _out(p.shape[0], torch.int32, p.device)
    found = _out(p.shape[0], torch.bool, p.device)
    _raw(lib.sstable_search_rows, lv.fences.data_ptr(), lv.keys.data_ptr(),
         lv.n_blocks.data_ptr(), lv.n.data_ptr(), rows.data_ptr(),
         p.data_ptr(), idx.data_ptr(), found.data_ptr(), p.shape[0],
         lv.fences.shape[1], lv.keys.shape[1], R)
    return idx, found


def _raw_stack(lib, bits, nw, p, k: int):
    import torch
    maybe = torch.empty((bits.shape[0], p.shape[0]), dtype=torch.bool,
                        device=p.device)
    _raw(lib.bloom_probe_stack, bits.data_ptr(), nw.data_ptr(), p.data_ptr(),
         maybe.data_ptr(), bits.shape[0], p.shape[0], bits.shape[1], k)
    return maybe


def _mean(xs):
    return None if any(x is None for x in xs) else sum(xs) / len(xs)


def _turns(name: str, fns: dict, plain, order) -> dict:
    """Every build of ``fns`` held to the plain version first (a mismatch
    fails the run), then device ms and call ms of each in ``order``, on
    the same tensors and probe sets within this process."""
    mism = {str(tag): _compare(fn, plain)[0] for tag, fn in fns.items()}
    if any(mism.values()):
        fail(f"{name}: a compared build disagrees with the plain version "
             f"({mism})")
    dev = {str(tag): [] for tag in fns}
    call = {str(tag): [] for tag in fns}
    for tag in order:
        dev[str(tag)].append(_device_ms(fns[tag], _symbol(name)))
        call[str(tag)].append(_time(fns[tag]))
    return {"order": [str(t) for t in order], "device_ms": dev, "ms": call,
            "mismatches": mism}


class Variants:
    """The builds ``--first-version DIR`` compares: ``first``, a library of
    the earlier sources in DIR (``names``: the kernels DIR holds a ``.cu``
    of), ``groups``, {G: the lane-group kernels built with G lanes a
    probe}, and ``stack_groups``, {G: the stack probe built with G lanes a
    (row, probe)}, all built at once.  Both sides of a comparison launch
    through the same ctypes call, so call ms compares like with like."""

    def __init__(self, first_dir: str):
        from concurrent.futures import ThreadPoolExecutor
        from repro_torch.kernels import build
        srcs = [os.path.join(first_dir, f"{n}.cu") for n in KERNELS
                if os.path.exists(os.path.join(first_dir, f"{n}.cu"))]
        if not srcs:
            fail(f"--first-version: no kernel source in {first_dir}")
        self.names = {os.path.basename(s)[:-3] for s in srcs}
        group_srcs = [build.CSRC / f"{n}.cu" for n in GROUP_MACROS]
        stack_src = [build.CSRC / "bloom_probe_stack.cu"]
        with ThreadPoolExecutor(1 + len(GROUPS) + len(STACK_GROUPS)) as ex:
            first = ex.submit(build.load_variant, srcs)
            groups = {g: ex.submit(build.load_variant, group_srcs,
                                   tuple(f"-D{m}={g}"
                                         for m in GROUP_MACROS.values()))
                      for g in GROUPS}
            stack = {g: ex.submit(build.load_variant, stack_src,
                                  (f"-D{STACK_GROUP_MACRO}={g}",))
                     for g in STACK_GROUPS}
            self.first = first.result()
            self.groups = {g: f.result() for g, f in groups.items()}
            self.stack_groups = {g: f.result() for g, f in stack.items()}

    def compare(self, entry: dict, name: str, make, plain) -> None:
        """First version against the current build, in turns first,
        current, current, first, when DIR holds ``name``; ``make(lib)``
        gives probe set i's launch on a library."""
        from repro_torch.kernels import build
        if name not in self.names:
            return
        entry["same_call"] = _turns(
            name, {"first": make(self.first), "current": make(build.load())},
            plain, ("first", "current", "current", "first"))
        entry["first_version_device_ms"] = _mean(
            entry["same_call"]["device_ms"]["first"])

    def sweep(self, name: str, make, plain) -> dict:
        """Each group size, in turns up and down: GROUPS (8, 16, 32, 32,
        16, 8), or STACK_GROUPS for the stack probe (1, 2, 4, 8, 8, 4, 2,
        1)."""
        libs = (self.stack_groups if name == "bloom_probe_stack"
                else self.groups)
        return _turns(name, {g: make(lib) for g, lib in libs.items()},
                      plain, tuple(libs) + tuple(libs)[::-1])


def kernel_checks(store, launches: dict, snapshot,
                  variants: Variants | None = None) -> list:
    import torch
    from repro_torch.core.bloom import hash2_torch, umod_torch
    from repro_torch.core.store import _PAD_PROBE
    from repro_torch.kernels import ref

    cfg = store.engine.cfg
    R = cfg.block_records
    li, lv, tables = snapshot
    dev = lv.keys.device
    level_keys = np.concatenate([t.keys for t in tables])
    lo, hi = int(level_keys[0]), int(level_keys[-1])
    models = (lv.starts, lv.slopes, lv.icepts, lv.nseg, lv.n)
    sets = []
    for s in range(TIMED_BATCHES):
        r = np.random.default_rng(1000 + s)
        p = np.concatenate([r.choice(level_keys, CHECK_B // 2),
                            r.integers(lo, hi, CHECK_B // 2, dtype=np.int64)])
        p[-8:] = _PAD_PROBE                       # pad lanes, as dispatched
        pt = torch.from_numpy(p).to(dev)
        f, _ = store.engine._find_file(lv, pt)
        rows = f.to(torch.int32)
        sets.append((rows, pt, ref.plr_lookup_rows_ref(*models, rows, pt)))
    rl = [s[0].long() for s in sets]

    # per kernel and probe set: (bytes, operations) this set's data needs —
    # each probe's reads counted once (8 B per gathered element), outputs
    # written once; operations are the 64-bit compares, adds and shifts
    w_bounded = _bounded_work(lv.keys, sets, cfg.plr_delta)

    def w_bloom(i):
        rows, p, _ = sets[i]
        m = lv.bloom_nw[rl[i]].long().clamp(min=1) * 64
        h1, h2 = hash2_torch(p)
        alive = torch.ones_like(p, dtype=torch.bool)
        words = torch.zeros_like(p)
        for t in range(cfg.bloom_k):
            words += alive.long()
            bit = umod_torch(h1 + t * h2, m)
            w = lv.bloom[rl[i], (bit >> 6).clamp(max=lv.bloom.shape[1] - 1)]
            alive = alive & (((w >> (bit & 63)) & 1) == 1)
        return (int((8 + 4 + 4 + 1 + 8 * words).sum()),
                int((10 + 6 * words).sum()))

    def w_sstable(i):
        rows, p, _ = sets[i]
        nb = lv.n_blocks[rl[i]].clamp(1, lv.fences.shape[1])
        lo = ref._bisect_rows(lv.fences, rows, p, torch.zeros_like(rl[i]),
                              nb, "right")
        base = (lo - 1).clamp(min=0) * R
        span = (torch.minimum(base + R, lv.n[rl[i]].long()) - base).clamp(min=0)
        st = _steps(nb) + _steps(span)
        return (int((8 + 4 + 4 + 4 + 4 + 1 + 8 * (st + 1)).sum()),
                int((4 * st + 4).sum()))

    kernels = [
        ("plr_lookup", "port/repro_torch/kernels/csrc/plr_lookup.cu",
         "src/repro/kernels/plr_lookup.py:66", *_plr_fns(models, sets),
         _plr_work(models, sets),
         "group=32 lanes/probe, G-ary count search"),
        ("bounded_search", "port/repro_torch/kernels/csrc/bounded_search.cu",
         "src/repro/kernels/bounded_search.py:61",
         *_bounded_fns(lv, sets, cfg.plr_delta),
         w_bounded, "group=32 lanes/probe"),
        ("bloom_probe", "port/repro_torch/kernels/csrc/bloom_probe.cu",
         "src/repro/kernels/bloom_probe.py:69",
         *_bloom_fns(lv, sets, cfg.bloom_k),
         w_bloom, "group=8 lanes/probe, one lane a hash"),
        ("sstable_search", "port/repro_torch/kernels/csrc/sstable_search.cu",
         "src/repro/kernels/sstable_search.py:95", *_sstable_fns(lv, sets, R),
         w_sstable, "group=32 lanes/probe, G-ary count search"),
    ]
    floor_ms = _floor_ms()
    out = []
    for name, src, replaces, kern, plain, work, design in kernels:
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    **_measure(kern, plain, work, _symbol(name)),
                    "library_ms": None, "design": design,
                    "floor_ms": floor_ms, "first_version_device_ms": None,
                    "level": li, "shape": {"F": lv.keys.shape[0],
                                           "C": lv.keys.shape[1],
                                           "S": lv.starts.shape[1],
                                           "W": lv.bloom.shape[1],
                                           "NB": lv.fences.shape[1],
                                           "B": CHECK_B}})
    by_name = {k["name"]: k for k in out}
    # the window and filter kernels past one group: δ = 40 (83 keys, three
    # chunks of 32) and k = 12 (two chunks of 8), on the same tensors
    wide = {"bounded_search": ({"delta": WIDE_DELTA},
                               *_bounded_fns(lv, sets, WIDE_DELTA)),
            "bloom_probe": ({"k": WIDE_K}, *_bloom_fns(lv, sets, WIDE_K))}
    for name, (arg, kern, plain) in wide.items():
        mism, err = _compare(kern, plain)
        by_name[name]["wide_check"] = {**arg, "mismatches": mism,
                                       "max_abs_err": err,
                                       "device_ms": _device_ms(
                                           kern, _symbol(name))}
    if variants is not None:
        makes = {
            "plr_lookup": lambda lib: (lambda i: _raw_plr(lib, models,
                                                          sets[i])),
            "bounded_search": lambda lib: (lambda i: _raw_bounded(
                lib, lv, sets[i], cfg.plr_delta)),
            "bloom_probe": lambda lib: (lambda i: _raw_bloom(
                lib, lv, sets[i], cfg.bloom_k)),
            "sstable_search": lambda lib: (lambda i: _raw_sstable(
                lib, lv, sets[i], R)),
        }
        plains = {"plr_lookup": _plr_fns(models, sets)[1],
                  "bounded_search": _bounded_fns(lv, sets, cfg.plr_delta)[1],
                  "bloom_probe": _bloom_fns(lv, sets, cfg.bloom_k)[1],
                  "sstable_search": _sstable_fns(lv, sets, R)[1]}
        for name, make in makes.items():
            variants.compare(by_name[name], name, make, plains[name])
        for name in ("plr_lookup", "sstable_search"):
            by_name[name]["group_sweep"] = variants.sweep(
                name, makes[name], plains[name])
        by_name["bounded_search"]["group_sweep"] = {
            f"delta_{d}": variants.sweep(
                "bounded_search",
                lambda lib, d=d: (lambda i: _raw_bounded(lib, lv, sets[i],
                                                         d)),
                _bounded_fns(lv, sets, d)[1])
            for d in (cfg.plr_delta, WIDE_DELTA)}
    return out


def _probe_sets(keys: np.ndarray, dev, seed: int, rows_of) -> list:
    """TIMED_BATCHES probe sets of CHECK_B: half ``keys``, half random in
    their range, pad lanes at the end; ``rows_of(probes)`` gives the file
    row of each.  Items are (rows int32, probes) on ``dev``."""
    import torch
    from repro_torch.core.store import _PAD_PROBE
    lo, hi = int(keys.min()), int(keys.max())
    sets = []
    for i in range(TIMED_BATCHES):
        r = np.random.default_rng(seed + i)
        p = np.concatenate([r.choice(keys, CHECK_B // 2),
                            r.integers(lo, hi, CHECK_B // 2, dtype=np.int64)])
        p[-8:] = _PAD_PROBE
        sets.append((torch.from_numpy(rows_of(p)).to(dev),
                     torch.from_numpy(p).to(dev)))
    return sets


def plr_shape_checks(st, variants: Variants | None = None) -> dict:
    """``plr_lookup`` against its plain version at the two other shapes the
    main path launches it at: the sharded state's stacked shard tables
    (phase D, ``dist_get_local``, rows = owning shard) and shard 0's widest
    level model (phase E, ``LookupEngine._probe_level_via_model``, one row
    padded to ``level_seg_cap``).  With ``variants``, the level model's
    shape also gets the first-version comparison and the group sweep."""
    state = st.device_state()
    sharded = (state["starts"], state["slopes"], state["icepts"],
               state["nseg"], state["n"])
    live = state["keys"][state["keys"] != np.iinfo(np.int64).max]
    sets_d = _probe_sets(live.cpu().numpy(), live.device, 3000, st.shard_of)
    sh = st.shards[0]
    ds = sh.engine.build_state(sh.tree, sh.level_models)
    li = max(range(len(ds.level_models)),
             key=lambda i: ds.level_models[i].n_seg)
    lm = ds.level_models[li]
    level_model = (lm.starts, lm.slopes, lm.icepts, lm.nseg, lm.total)
    sets_e = _probe_sets(np.concatenate([t.keys for t in sh.tree.levels[li]]),
                         lm.starts.device, 4000,
                         lambda p: np.zeros(p.shape, np.int32))
    out = {}
    for tag, tables, sets in (("shards", sharded, sets_d),
                              ("level_model", level_model, sets_e)):
        kern, plain = _plr_fns(tables, sets)
        out[tag] = {**_measure(kern, plain, _plr_work(tables, sets),
                               _symbol("plr_lookup")),
                    "shape": {"F": tables[0].shape[0],
                              "S": tables[0].shape[1], "B": CHECK_B,
                              "nseg": tables[3].tolist()}}
    out["level_model"]["level"] = li
    if variants is not None:
        def make(lib):
            return lambda i: _raw_plr(lib, level_model, sets_e[i])
        plain = _plr_fns(level_model, sets_e)[1]
        variants.compare(out["level_model"], "plr_lookup", make, plain)
        out["level_model"]["group_sweep"] = variants.sweep("plr_lookup",
                                                           make, plain)
    return out


def stack_checks(st, fstate, launches_abc: dict, launches_de: dict,
                 variants: Variants | None = None) -> dict:
    """``bloom_probe_stack`` against its plain version at both of its live
    shapes — the sharded state's (4, fw) shard rows (phase D) and the shard
    engine's (7, W) FilterState (phase E) — over rotated probe sets of
    4096 (half keys of the rows, half random, pad lanes at the end).  The
    entry's times are those of the (4, fw) shape, the server's path; the
    (7, W) shape's sit under ``engine_shape``.  With ``variants``, each
    shape also gets the first-version comparison and the group sweep.
    ``launches_abc`` and ``launches_de`` are the counts read after phases
    A–C and D–E."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    state = st.device_state()
    k = st.shards[0].cfg.lsm.bloom_k
    keys = state["keys"][state["keys"] != np.iinfo(np.int64).max]
    sets = [p for _, p in _probe_sets(keys.cpu().numpy(), keys.device, 2000,
                                      lambda p: np.zeros(p.shape, np.int32))]
    out = {}
    for tag, bits, nw in (("shards", state["fbits"], state["fnw"]),
                          ("engine", fstate.bits, fstate.nw)):
        kern = (lambda i, b=bits, n=nw: ops.bloom_probe_stack(b, n, sets[i],
                                                              k))
        plain = (lambda i, b=bits, n=nw: ref.bloom_probe_stack_ref(
            b, n, sets[i], k))
        out[tag] = {**_measure(kern, plain, _stack_work(bits, nw, sets, k),
                               _symbol("bloom_probe_stack")),
                    "shape": {"L": bits.shape[0], "W": bits.shape[1],
                              "B": CHECK_B,
                              "rows_with_filter": int((nw > 0).sum())}}
    main = out["shards"]
    entry = {"name": "bloom_probe_stack", "route": "cuda",
             "source": "port/repro_torch/kernels/csrc/bloom_probe_stack.cu",
             "replaces": "src/repro/kernels/bloom_probe.py:121",
             "launches": (launches_abc["bloom_probe_stack"]
                          + launches_de["bloom_probe_stack"]),
             "launches_abc": launches_abc["bloom_probe_stack"],
             "launches_de": launches_de["bloom_probe_stack"],
             **{key: main[key] for key in (
                 "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                 "bytes_per_launch", "ops_per_launch", "shape")},
             "max_abs_err": max(v["max_abs_err"] for v in out.values()),
             "mismatches": sum(v["mismatches"] for v in out.values()),
             "library_ms": None,
             "design": "grid (probe tiles, rows), group=8 lanes/(row, "
                       "probe), one lane a hash; filterless rows exit per "
                       "block",
             "floor_ms": _floor_ms(), "first_version_device_ms": None,
             "engine_shape": out["engine"]}
    if variants is not None:
        for rec, bits, nw in ((entry, state["fbits"], state["fnw"]),
                              (out["engine"], fstate.bits, fstate.nw)):
            def make(lib, b=bits, n=nw):
                return lambda i: _raw_stack(lib, b, n, sets[i], k)

            def plain(i, b=bits, n=nw):
                return ref.bloom_probe_stack_ref(b, n, sets[i], k)

            variants.compare(rec, "bloom_probe_stack", make, plain)
            rec["group_sweep"] = variants.sweep("bloom_probe_stack", make,
                                                plain)
    return entry


def _floor_ms() -> float | None:
    """The per-launch floor: device time of one trivial PyTorch kernel (an
    int32 add) over CHECK_B elements, the least any launch takes here."""
    import torch
    x = torch.zeros(CHECK_B, dtype=torch.int32, device="cuda")
    y = torch.empty_like(x)
    return _device_ms(lambda i: torch.add(x, i, out=y), "elementwise_kernel")


def _device_ms(fn, symbol: str) -> float | None:
    """Mean device time per launch of the kernel named ``symbol``, from
    torch.profiler over one pass of the probe sets: the kernel's own run
    time, without the host's launch path that back-to-back calls wait on.
    The profiler runs a warm-up pass first and records the second (it
    drops launches at the start of a session).  A pass that still records
    fewer launches than it made is repeated, up to PROFILE_TRIES passes,
    and the pass that recorded the most is reported (None if none recorded
    a launch)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    best = (0, 0.0)
    for _ in range(PROFILE_TRIES):
        recorded = []
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: recorded.append(
                         p.key_averages())) as prof:
            for _ in range(2):
                for i in range(TIMED_BATCHES):
                    fn(i)
                torch.cuda.synchronize()
                prof.step()
        us = calls = 0
        for e in (recorded[0] if recorded else []):
            if e.device_type == DeviceType.CUDA and symbol in e.key:
                us += getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
                calls += e.count
        best = max(best, (calls, us))
        if calls >= TIMED_BATCHES:
            break
    calls, us = best
    return us / calls / 1e3 if calls else None


def _time(fn) -> float:
    """Milliseconds per call, CUDA events over rotated probe sets.  Each
    call is a Python wrapper plus a ctypes launch, so for a kernel that
    runs for a few microseconds this is the host's launch rate."""
    import torch
    for i in range(TIMED_BATCHES):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_ROUNDS):
        for i in range(TIMED_BATCHES):
            fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (TIMED_ROUNDS * TIMED_BATCHES)


# phase A's OSM-like keys (``--keys``): 1 << 23 until phase Q, whose ~270 s
# (an NVIDIA H100 80GB HBM3, 700.00 W) this cut and P_RUNS' pay for
A_KEYS = 1 << 22
# phase D's ar keys (``--shard-keys``): 1 << 22 until phase Q; with the cuts
# above the smoke took 977.3 s on one host and 1,101.8 s on another (the
# host-bound phases A-L 144 s slower; the same card), so D's load is halved
D_KEYS = 1 << 21


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=A_KEYS,
                    help="OSM-like keys loaded into the store (the host "
                         "LSM load of 1 << 24 does not fit the run's time)")
    ap.add_argument("--shard-keys", type=int, default=D_KEYS,
                    help="ar keys loaded into the sharded store of phases "
                         "D and E (the bench_dist_recovery config at "
                         "2M keys instead of its 128K)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--first-version", metavar="DIR",
                    help="time every kernel whose .cu DIR holds against "
                         "its current build, the lane-group kernels at 8, "
                         "16 and 32 lanes a probe and the stack probe at 1, "
                         "2, 4 and 8, in turns")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "port"))
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import build, ops
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    build.load()
    print(f"kernels built in {time.perf_counter() - t0:.1f}s")
    for line in build.ptxas_log().splitlines():
        if ("registers" in line or "spill" in line or line.startswith("==")
                or "Compiling entry" in line):
            print("ptxas:", line.strip())
    variants = None
    if args.first_version:
        t0 = time.perf_counter()
        variants = Variants(args.first_version)
        print(f"compared builds ({sorted(variants.names)} from "
              f"{args.first_version}; groups {GROUPS}, stack groups "
              f"{STACK_GROUPS}) built in "
              f"{time.perf_counter() - t0:.1f}s")

    hot = HotSyncs()
    store, launches, snapshot = drive("cuda", args.keys, args.seed, card,
                                      hot=hot)
    checks = kernel_checks(store, launches, snapshot, variants)
    for k in checks:
        if k["launches"] <= 0:
            fail(f"{k['name']} never launched on the main path")
    del store, snapshot
    gc.collect()
    st, launches_de, fstate, shard_dir, truth, d_batches = drive_sharded(
        "cuda", args.shard_keys, args.seed, card, hot=hot)
    try:
        for name in ("bloom_probe_stack", "plr_lookup", "bounded_search"):
            if launches_de[name] <= 0:
                fail(f"{name} never launched on the sharded path (D, E)")
        for k in checks:
            k["launches_abc"] = k["launches"]
            k["launches_de"] = launches_de[k["name"]]
            k["launches"] += launches_de[k["name"]]
        plr = next(k for k in checks if k["name"] == "plr_lookup")
        shapes = plr_shape_checks(st, variants)
        plr["shard_shape"] = shapes["shards"]
        plr["level_model_shape"] = shapes["level_model"]
        checks.append(stack_checks(st, fstate, launches, launches_de,
                                   variants))
        served = drive_served(st, truth, args.seed, card)
        launches_f = served["launches"]
        for name in ("bloom_probe_stack", "plr_lookup", "bounded_search"):
            if launches_f[name] <= 0:
                fail(f"{name} never launched on the served path (F)")
        for k in checks:
            k["launches_f"] = launches_f[k["name"]]
            k["launches"] += launches_f[k["name"]]
            if k["name"] in served["served_shape_checks"]:
                k["served_shape"] = served["served_shape_checks"][k["name"]]
        st, g, g_sets = drive_mesh(st, shard_dir, truth, d_batches,
                                   args.shard_keys, args.seed, "cuda", card,
                                   hot=hot)
        mesh_shapes = mesh_shape_checks(st, d_batches, g_sets, args.seed)
        for k in checks:
            k["launches_g"] = g["launches"][k["name"]]
            k["launches"] += g["launches"][k["name"]]
            for tag, recs in mesh_shapes.items():
                if k["name"] in recs:
                    k[tag] = recs[k["name"]]
        st.close()
    finally:
        shutil.rmtree(shard_dir, ignore_errors=True)
    del st
    gc.collect()
    torch.cuda.empty_cache()
    _, launches_h, sessions, h_sets, left = drive_lm("cuda", args.seed, card)
    for name in KERNELS[:4]:
        if launches_h[name] <= 0:
            fail(f"{name} never launched on the served LM path (H)")
    session_shapes = session_shape_checks(sessions.store, h_sets)
    for k in checks:
        k["launches_h"] = launches_h[k["name"]]
        k["launches"] += launches_h[k["name"]]
        if k["name"] in session_shapes:
            k["session_shape"] = session_shapes[k["name"]]
    gc.collect()
    torch.cuda.empty_cache()
    i_cfg = dataclasses.replace(get_config(I_ARCH), n_units=I_SERVE_UNITS)
    drops = DropCount(i_cfg.top_k)
    rec_i, launches_i, i_sets = drive_model(sessions, left, args.seed, card,
                                            "cuda", i_cfg, watch=drops.on)
    rec_i["moe"] = drops.summary(rec_i["prefill_steps"])
    print(json.dumps(rec_i))
    for name in KERNELS[:4]:
        if launches_i[name] <= 0:
            fail(f"{name} never launched on the served MoE path (I)")
    i_shapes = session_shape_checks(sessions.store, i_sets)
    for k in checks:
        k["launches_i"] = launches_i[k["name"]]
        k["launches"] += launches_i[k["name"]]
        if k["name"] in i_shapes:
            k["session_shape_i"] = i_shapes[k["name"]]
    left = (left[0], left[1] + rec_i["background_batches_while_serving"])
    del rec_i, drops
    gc.collect()
    torch.cuda.empty_cache()
    rec_j, launches_j, j_sets = drive_model(
        sessions, left, args.seed, card, "cuda",
        dataclasses.replace(get_config(J_ARCH), n_units=J_SERVE_UNITS),
        n_requests=J_REQUESTS, tag="J")
    print(json.dumps(rec_j))
    for name in KERNELS[:4]:
        if launches_j[name] <= 0:
            fail(f"{name} never launched on the served recurrent path (J)")
    j_shapes = session_shape_checks(sessions.store, j_sets)
    for k in checks:
        k["launches_j"] = launches_j[k["name"]]
        k["launches"] += launches_j[k["name"]]
        if k["name"] in j_shapes:
            k["session_shape_j"] = j_shapes[k["name"]]
    del sessions, left
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "I2", **moe_logit_checks(args.seed, "cuda"),
                      "card": card}))
    print(json.dumps({"phase": "J2", **ssm_logit_checks(args.seed, "cuda"),
                      "card": card}))
    ops.reset_launches()                 # the training path starts here
    rec_k = drive_train(args.seed, card)
    launches_k = dict(ops.launches)
    rec_k["launches"] = launches_k
    print(json.dumps(rec_k))
    for k in checks:
        k["launches_k"] = launches_k[k["name"]]
    del rec_k
    print(json.dumps({"phase": "K2", **train_grad_checks(args.seed, "cuda"),
                      "card": card}))
    print(json.dumps({"examples": run_examples(), "card": card}))
    gc.collect()
    torch.cuda.empty_cache()
    rec_l1 = drive_store_cell(card)      # its own process counts launches
    m = rec_l1["measured"]
    print(json.dumps({
        "phase": "L1", "mesh": rec_l1["mesh"], "n_keys": rec_l1["n_keys"],
        "probe_batch": rec_l1["probe_batch"],
        "plan_bytes_per_position": rec_l1["memory"]["peak_bytes"],
        "plan_bytes_all_positions": (rec_l1["memory"]["peak_bytes"]
                                     * rec_l1["n_devices"]),
        "plan_memory": rec_l1["memory"],
        "plan_collectives": rec_l1["collectives"],
        "measured_peak_device_bytes": m["peak_device_bytes"],
        "state_bytes": m["state_bytes"], "build_s": m["build_s"],
        "median_get_ms": m["median_get_ms"], "get_ms": m["get_ms"],
        "launches_per_get": m["launches_per_get"],
        "answers_checked": m["answers_checked"],
        "process_s": rec_l1["process_s"], "card": m["card"]}))
    store_shapes = store_shape_checks(rec_l1)
    for k in checks:
        k["launches_l"] = int(m["launches_per_get"][k["name"]] * m["gets"])
        k["launches"] += k["launches_l"]
        k.update(store_shapes.get(k["name"], {}))
    t0 = time.perf_counter()
    plans = drive_plans(card)
    print(json.dumps({"phase": "L2", "cells": plans,
                      "s": time.perf_counter() - t0, "card": card}))
    ops.reset_launches()
    t0 = time.perf_counter()
    rec_l3 = drive_rules_steps(args.seed)
    print(json.dumps({"phase": "L3", **rec_l3, "launches": dict(ops.launches),
                      "s": time.perf_counter() - t0, "card": card}))
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()         # phases M, N and O: the sharded serve step
    t0 = time.perf_counter()
    rec_mn = drive_sharded_serve(args.seed, card)
    for phase, tags in (("M", M_RUNS), ("N", N_RUNS), ("O", O_RUNS)):
        print(json.dumps({"phase": phase, "backend": rec_mn["backend"],
                          "cards": rec_mn["cards"],
                          **{t: rec_mn[t] for t in tags},
                          "s": sum(rec_mn[t]["s"] for t in tags),
                          "card": card}))
    print(f"phases M, N and O {time.perf_counter() - t0:.1f}s (spawn "
          f"{rec_mn['spawn_s']:.1f}s)")
    for k in checks:
        for phase in "MNO":
            k[f"launches_{phase.lower()}"] = rec_mn["launches"][phase].get(
                k["name"], 0)
    del rec_mn
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()         # phase P: the sharded train step
    t0 = time.perf_counter()
    rec_p = drive_sharded_train(args.seed, card)
    print(f"phases P and Q {time.perf_counter() - t0:.1f}s (spawn "
          f"{rec_p['spawn_s']:.1f}s)")
    for k in checks:
        k["launches_p"] = rec_p["launches"]["P"].get(k["name"], 0)
        k["launches_q"] = rec_p["launches"]["Q"].get(k["name"], 0)
    del rec_p
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec_r = drive_gates(card)    # phase R: the correctness gates
    print(f"phase R {time.perf_counter() - t0:.1f}s")
    for k in checks:
        for tag, r in rec_r.items():
            n = r["launches"][k["name"]]
            k[f"launches_{tag.lower()}"] = n
            k["launches"] += n
            if k["name"] in r["checks"]:
                k[f"gate_shape_{tag.lower()}"] = r["checks"][k["name"]]
    for k in checks:
        other = {tag: k[tag]["mismatches"]
                 for tag in ("wide_check", "shard_shape", "level_model_shape",
                             "engine_shape", "served_shape", "mesh_shape",
                             "mesh_dispatched_shape", "mesh_example_shape",
                             "session_shape", "session_shape_i",
                             "session_shape_j", "store_shape",
                             "store_row_shape", "gate_shape_r1",
                             "gate_shape_r2")
                 if tag in k}
        if k["mismatches"] != 0 or any(other.values()):
            fail(f"{k['name']} disagrees with its plain version on "
                 f"{k['mismatches']} outputs (other checks: {other})")
    hot_line = hot.line()
    for phase, r in hot_line.items():
        if r["static_findings"]:
            fail(f"phase {phase}: the port's HOTSYNC rule flags "
                 f"{r['static_findings']} calls in the functions its "
                 f"dispatch halves ran")
    print(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"hot_syncs": hot_line, "card": card}))
    print(json.dumps({"kernels": checks}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
