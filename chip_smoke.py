#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--profile]

Phases (progress on stdout, any failure raises and exits non-zero):

1. build             — compile every CUDA kernel from
                       ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
                       source, all in parallel);
1a. models           — the model substrate: (a) each of the ten
                       architectures at its smoke config, seeded weights
                       made on the CPU and copied to the card,
                       ``forward_logits``, ``forward_train``'s loss and 8
                       ``decode_step``s on the card against the CPU at
                       rtol = atol = 2e-2 (the SSM and hybrid families at
                       0.1 / 0.12), every layer run on the CPU's own input
                       to it and the CPU's experts replayed where the
                       routers split a near tie (``ROUTE_TIE``, at most
                       ``ROUTE_TIE_SHARE`` of the rows), then the same
                       runs unforced, end to end, held for the families
                       without routing; (b) qwen3-0.6b at full width (28
                       layers, d_model 1024) served through
                       ``repro_torch.launch.serve`` at batch 4, prompt 32,
                       gen 32: prefill and decode walls, decode tok/s,
                       ``max_memory_allocated``, and the prefill's decode
                       logits against ``forward_logits`` on the same
                       prompt at rtol = atol = 5e-2 (largest difference,
                       argmax agreement); (c) the other nine at their
                       published widths (depth cut by ``WIDE_DEPTH``): the
                       SSM pair held to the CPU as in (a), the rest with
                       32 prompt tokens (the MoE pair 4) through
                       ``decode_step`` against ``forward_logits`` (the MoE
                       pair layer by layer),
                       the loss finite, peak memory; no hand kernel may
                       launch; (d) training: each smoke config's state
                       made on the CPU and copied to the card, three
                       ``make_train_step`` steps on both (llama3.2-1b
                       with two microbatches, qwen3-0.6b with int8
                       gradient compression, the MoE pair with the CPU's
                       experts replayed at near ties): metrics, moments
                       and parameters held (``run_train``); llama3.2-1b
                       at full width (16 layers, d_model 2,048, vocab
                       128,256) through ``repro_torch.launch.train
                       --kb-corpus --steps 10``: the loss falls, the
                       stream equals the CPU's (``KB_STREAM_TOKENS``),
                       the corpus build launches ``TRAIN_KERNELS`` and
                       the steps none; step wall, tokens/s, peak memory,
                       losses, corpus wall; ``run_with_recovery`` against
                       an uninterrupted run under deterministic
                       algorithms; (e) sharding: llama3.2-1b at full
                       width, its state placed by ``state_shardings`` on
                       the 1x1 mesh over NCCL (DTensors) and its batches
                       by ``batch_shardings``, 3 steps against 3 plain
                       steps from the same seed (metrics, grad_norm, each
                       parameter's change; both step walls), and the
                       MoE block at qwen2-moe-a2.7b's published width
                       through the expert-parallel path for a logical
                       (data 2, model 4) and (data 2, model 8) layout,
                       each shard's block in turn, against the gather
                       path by data shard (y, aux, the gradients); no
                       hand kernel may launch; (f) roofline: part (d)'s
                       full-width step counted on the card by
                       ``repro_torch.roofline.op_cost.count_ops`` (its
                       warm-up step, not a timed one), whose FLOPs must
                       equal the dry run's (``launch/dryrun.py``) count of
                       the same step at the same shape on the 1x1 mesh of
                       meta DTensors (a process of its own, no card,
                       started after part (e) and run beside phases 2-3,
                       whose checks time nothing: the phase reports after
                       phase 3); the
                       roofline row against the H100's published peaks
                       beside the measured step wall (compute and memory
                       terms, bottleneck, model FLOPs and counted FLOPs
                       over peak over wall), with the card's name and
                       power limit;
2. small             — ``CMatEngine(fused=True)`` on the card against the
                       same engine on the CPU, on five small workloads; then
                       each again with the derivation journal on, and
                       ``FlatEngine`` likewise, on the card and on the CPU:
                       the journal-off fact sets, equal records but for
                       ``time_ns``, equal verified proof trees of up to 50
                       derived facts;
3. small-query       — ``tests/test_query.py``'s query lists on its KBs and
                       ``benchmarks/bench_query.py``'s queries on its
                       non-smoke KBs, answered by ``QueryEngine`` over a
                       card store and over a CPU store, cold and cached:
                       answers, ``explain()`` text, every non-timing
                       ``ExecStats`` field and ``BatchStats`` equal; the
                       two-constant lookups that reach ``in_set``;
4. full              — ``lubm_like(n_dept=500, n_students=1_000_000,
                       n_courses=10_000)`` loaded and materialised on the
                       card with ``fused=True``, its fact set held against
                       the flat oracle on the CPU;
5. query             — that store frozen and queried on the card:
                       ``bench_query.py``'s four lubm queries, a query of
                       two constant-bound atoms, a true and a false
                       two-constant ASK (``in_set``), and a 32-query
                       ``answer_batch`` (``BATCH_TEMPLATE``), each answer
                       equal to ``answer_flat`` over the CPU oracle; card
                       walls (median of 5 after a warm-up), the flat CPU
                       walls, ``ExecStats`` fractions, launches, host syncs,
                       the snapshots' build time and bytes; the store's
                       node count and id counter unchanged by the stream;
5a. provenance       — phase 4's load and materialise again with the
                       journal on under a ``MemorySampler``: the same fact
                       set and stats; records, dropped, journal bytes, the
                       ``rule.*`` gauges, ``mem.peak.materialise.*``; 20
                       derived facts drawn with seed 0 explained on the card,
                       each verified and re-checked on its own against the
                       CPU flat oracle (every node in the oracle, every leaf
                       explicit, every rule applied to exactly its children
                       yields its node); the table-build wall, the median and
                       largest explain wall; the host syncs of a journal-off
                       (equal to phase 16's) and a journal-on materialise;
6. small-distributed — ``DistributedEngine`` on the card against the same
                       engine on the CPU at 1 and 4 shards (the 4 all on the
                       card) on three small workloads, one that must regrow
                       its join padding and, at 4 shards, one that must
                       regrow an exchange bucket (``HUB_KW``): fact sets,
                       stats and every shard's state buffers row for row;
                       with the journal on, the records after
                       ``merge_shard_records`` equal;
7. full-distributed  — ``lubm_like(500, 30_000, 1_000)`` (the largest KB the
                       engine's 15-bit ids allow at this shape) materialised
                       on the card at 1 shard and again at 4 shards (each
                       with ``capacity`` 2**18 a shard), its stats held
                       against the JAX reference's (``DIST_EXPECTED``,
                       ``DIST_EXPECTED_4``) and its fact set against the
                       flat oracle; then one ``apply`` deleting about 1 % of
                       ``takesCourse`` and ``advisor`` and one adding them
                       back, each held against the flat oracle of the edited
                       explicit set; the walls at 1 and 4 shards side by
                       side, the launches per kernel of each;
7a. examples         — ``repro_torch.examples.quickstart`` and
                       ``distributed_reasoning`` on the card, each checking
                       itself against the flat oracle; their rounds;
8. closure           — every two-atom rule whose head pairs a left-only and
                       a right-only variable applied once more to the full
                       store through ``fused_join_dedup`` (regrown to its
                       pair total), merged into an int32 ``FactBuffers``
                       seeded with the head relation: nothing may be new;
                       each rule's inputs equal to the flat oracle's, every
                       launch recorded and matched by the launch meter;
9. kernels           — each kernel against its plain PyTorch version on the
                       card (int32 and int64; ``fused_join_dedup`` int32
                       only): seeded inputs at the operand lengths of its
                       largest launch on the main path (read from the launch
                       meter) plus edge cases, exact equality.  At those
                       lengths (in int64; ``sorted_member`` and
                       ``rle_expand`` in both key types, ``rle_expand`` also
                       with one run holding 90 % of the output,
                       ``sorted_member`` and ``join_bounds`` also at the
                       largest launches in int32 of the 1-shard distributed
                       ``apply`` and of the 4-shard materialise and
                       ``apply``, these two and ``rle_expand`` at the query
                       phase's largest launch in int64, with the
                       query path's own shapes ``query-one-constant`` (one
                       constant against a long candidate slice) and
                       ``query-one-key`` (one key against a long sorted
                       column), ``join_bounds`` also at the CMat run's own
                       two largest launches, ``CMAT_DISJOINT`` and
                       ``CMAT_XJOIN``, the merge at the closure's largest
                       launch in int32, ``fused_join_dedup`` also at each
                       of the closure's own five launches,
                       ``closure-<head>-<capacity>``, rebuilt from the flat
                       oracle of its KB): kernel and library call timed
                       in alternating turns (kernel, library, library,
                       kernel, five times; medians of CUDA-event means), the
                       device-only time of each from ``torch.profiler`` (and
                       the kernels it ran per call: the merge, called with
                       its ``count`` as ``FactBuffers`` calls it, and the
                       join must each run one kernel and no library scan or
                       sort), the kernel's host time per call, the plain
                       version's time and the bytes bound; the
                       ``join_bounds`` path sweep, through the tuner
                       (``kernels/tune.py``, its cache in a temporary
                       directory): the path it picks at each point beside
                       the hand-set rule's, a second lookup a cache hit;
                       and at each timed ``join_bounds`` case (the main
                       path's launches), where the path the main path's
                       tuner cache routes it to is not the hand-set
                       rule's, both paths' device-only times: the tuned
                       one may not be the slower;
10. serve-small      — the port's server (``repro_torch.launch.serve_datalog``,
                       in-process) at ``--kb lubm --scale 1``, static and
                       ``--live --live-verify``, with ``--provenance
                       --hot-rules --explain-sample 8 --explain
                       "Agent(prof6)"``, on the card and with ``--device
                       cpu``: every non-timing report field equal
                       (``hot_rules`` by ``rule_id`` against the two equal
                       cost tables), every explanation verified;
11. serve            — the static server at ``--scale 10000``
                       (``lubm_like(40_000, 1_000_000, 80_000)``) with 1,000
                       queries on the card: its fact count and answer total
                       equal the flat oracle's (``flat_seminaive`` and
                       ``answer_flat``, plain versions only, on the card);
                       q/s, p50/p90/p99, hit rate, mu-nodes, launches, and the
                       host syncs of one more pass of the stream;
12. live             — the live server there (``--live --update-every 50
                       --update-size 8 --live-verify``, 150 queries, 2
                       batches: cut from 250 and 4 to keep the whole run
                       within 80 % of its time limit, phase 13 applying 4
                       batches to the same store), ending ``[live-verify] OK`` at an epoch equal
                       to the batches applied: apply p50/p99, the ``inc.*``
                       counts, launches, ``max_memory_allocated``, and the
                       host syncs of one more batch; then the largest
                       ``sorted_member``, ``join_bounds`` and ``rle_expand``
                       launch of phases 11 and 12 are timed after phase 15
                       (the profiler's traces lose events after these
                       phases, so phase 9 runs before them);
13. durable          — a snapshot of the server at ``--scale 1`` written from
                       the card and from the CPU: equal ``data.bin`` SHA-256
                       and ``provenance.json`` but for ``time_ns``, each
                       restoring on the other device to the same ``to_dict``,
                       loading the other's sidecar and explaining 8 facts;
                       then the live server at ``--scale 10000`` with
                       ``--provenance --hot-rules --explain-sample 8``,
                       ``--checkpoint-dir`` and a checkpoint every 3
                       batches, stopped by a simulated crash in place of its
                       final checkpoint (snapshot at epoch 3, the 4th batch
                       in the WAL), and the same server again in process
                       with ``--restore``: ``[restore] warm start`` from
                       epoch 3, one WAL batch replayed, epoch 4, the store
                       equal to the crashed one, ``[live-verify] OK``, the
                       epoch-3 snapshot's ``provenance.json`` loaded by the
                       restore and 8 explanations after the replayed batch
                       verified; the checkpoint wall, the snapshot's bytes, the restore's
                       snapshot and replay walls against the cold load, and
                       the host syncs of the restore (its stream: 10
                       queries);
14. mvcc             — ``--mvcc --concurrency 4 --live --live-verify`` there,
                       25 queries with a batch every 13 (cut from 100 with
                       a batch every 50, then from 50 with a batch every
                       25: one generalised micro-batch took 150-250 s, which
                       pushed the whole smoke past 1,000 s of its 1,200;
                       still one batch through the writer), warm-started from phase 13's directory
                       with the journal off (its snapshot's sidecar is not
                       loaded), checkpointing every 2 batches: zero stale reads, the tier's epoch the
                       restored epoch plus the batches applied, ``[live-verify]
                       OK``; q/s, p50/p90/p99, apply p50/p99, epochs published
                       and retired, the peak number pinned, launches, peak
                       memory;
15. serve-distributed — ``--distributed`` at ``--scale 270`` (the largest
                       whose ids stay below the engine's 2**15), static and
                       ``--live --live-verify``, at the server's own shard
                       count (one a visible card: 1 here): ``[dist-verify]
                       OK`` after the
                       materialise and after the batches; the distributed
                       materialise and apply walls and launches; then the
                       largest ``sorted_member``, ``join_bounds`` and
                       ``rle_expand`` launch of phases 11 and 12, and of
                       phases 13-15 where larger, against the plain version
                       and timed against the library call, event-timed;
16. syncs            — the phase-4 materialisation once more with CUDA's
                       sync debug mode on, counting host synchronisations;
17. profile          — only with ``--profile``: one more load and
                       materialise of phase 4, one pass of phase 5's query
                       stream over it (snapshots and plans built before the
                       trace), and one more distributed materialise and 1 %
                       delete ``apply`` of phase 7, under ``torch.profiler``,
                       with device-busy time, launch counts and the top
                       device and host operators; and, within phase 12, one
                       more live batch and the 50 queries after it.

On the card ``join_bounds`` takes the path the tuner picks for its key
type and the size buckets of its two sides (swept once a pair of
buckets); the run keeps the tuner's cache in a temporary directory of
its own.

Launch counts are zeroed just before each main-path run (phases 1a, 1a (d)'s
full-width run, 1a (e), 4, 5, 5a,
7 at each shard count, 8, 11-15; phase 13's crashed run and its restore apart) and read just
after; every kernel of a path must have launched there.  A tuner sweep
inside a run is metered apart (``ops.tuning_counts``) and logged with the
run's counts (``[tune]``): its launches, and the seconds of the run's wall
it took.

Then one JSON line with every kernel's numbers, the card's name and power
limit, and as the last line the device JSON object.  Without a card, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
#: where the join_bounds tuner keeps its cache (``kernels/tune.py``)
TUNE_CACHE_ENV = "REPRO_TORCH_TUNE_CACHE"

N_DEPT, N_STUDENTS, N_COURSES = 500, 1_000_000, 10_000

#: the distributed engine's full-size KB: 163,500 explicit triples, largest
#: id 32,500 (below its 2**15 limit); buffers sized as serve_datalog sizes
#: them, twice the largest predicate (119,755 rows) rounded up
DIST_KB = {"n_dept": 500, "n_students": 30_000, "n_courses": 1_000}
DIST_CAPACITY = 1 << 18
#: what the JAX reference's ``DistributedEngine`` gives on this KB (one
#: shard, seed 0), with its 680,331 facts over 21 predicates
DIST_EXPECTED = {
    "rounds": 15,
    "n_strata": 14,
    "n_rule_applications": 24,
    "rule_applications_skipped": 5,
    "rows_joined": 149_912,
    "exchange_regrows": 0,
}
#: the same at 4 shards: the JAX reference on 4 forced CPU devices (seed 0)
DIST_EXPECTED_4 = {
    "rounds": 15,
    "n_strata": 14,
    "n_rule_applications": 24,
    "rule_applications_skipped": 5,
    "rows_joined": 149_912,
    "exchanges": 11,
    "exchanges_skipped": 14,
    "exchange_regrows": 0,
}
DIST_FACTS, DIST_PREDICATES = 680_331, 21

REPLACES = {
    "sorted_member": "src/repro/kernels/sorted_member.py:55",
    "join_bounds": "src/repro/kernels/join_bounds.py:65",
    "rle_expand": "src/repro/kernels/rle_expand.py:43",
    "merge_sorted_unique": "src/repro/kernels/fused.py:215",
    "fused_join_dedup": "src/repro/kernels/fused.py:110",
}


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One progress line, stamped with the seconds since the start."""
    print(f"{time.perf_counter() - _T0:7.1f} s {msg}", flush=True)


#: the join_bounds tuner's sweeps inside each main-path run: the function
#: that read the run's launch counts, and ``ops.tuning_counts()``
TUNING_IN_RUNS: list[tuple[str, dict]] = []


def launch_counts() -> dict[str, int]:
    """``ops.launch_counts()`` of the main-path run just ended, with the
    join_bounds tuner's sweeps since the counts were zeroed logged beside
    them (``ops.tuning_counts()``): the sweeps' launches are metered
    there, not in the kernels' counts, and their wall lies inside the
    run's."""
    from repro_torch.kernels import ops

    tuning = ops.tuning_counts()
    if tuning["sweeps"]:
        run = sys._getframe(1).f_code.co_name
        TUNING_IN_RUNS.append((run, tuning))
        log(f"[tune] {run}: {tuning['sweeps']} join_bounds sweeps, {tuning['launches']} "
            f"launches, {tuning['seconds']:.4f} s of the run's wall")
    return ops.launch_counts()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` over ``reps`` calls between two CUDA events:
    the card's time, or the host's where its launches cannot keep up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def alternating_ms(kernel_fn, library_fn, rounds: int = 5) -> tuple[float, float]:
    """Median :func:`cuda_ms` of the kernel and of the library call, timed
    in turns — kernel, library, library, kernel — ``rounds`` times."""
    k, lib = [], []
    for _ in range(rounds):
        k.append(cuda_ms(kernel_fn))
        lib += [cuda_ms(library_fn), cuda_ms(library_fn)]
        k.append(cuda_ms(kernel_fn))
    return statistics.median(k), statistics.median(lib)


def host_ms(fn, reps: int = 20) -> float:
    """Host time of one call of ``fn``: the wall clock of ``reps`` calls
    before the closing synchronisation (enqueue only), over ``reps``."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / reps


def device_ms(fn, reps: int = 20, tries: int = 3) -> tuple[float | None, dict[str, float]]:
    """Device time of one call of ``fn`` from ``torch.profiler``: the self
    device time of every kernel, copy and set the card ran over ``reps``
    calls, over ``reps`` (``None`` when the trace holds no device time);
    and how many times per call the card ran each of them, by name.  A
    trace that holds no device activity at all is the profiler's failure
    (it happens on the card's host now and then), so it is taken again, up
    to ``tries`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if dev:
            break
    us = sum(_device_us(e) for e in dev)
    return (us / reps / 1e3 if us else None), {e.key: e.count / reps for e in dev}


# --------------------------------------------------------------------- #
# phase 1a: the model substrate (configs/, models/, launch/serve.py)
# --------------------------------------------------------------------- #
#: every architecture at its smoke config: batch, sequence, decode steps
MODEL_B, MODEL_S, MODEL_STEPS = 2, 32, 8
#: (rtol, atol): bf16 compute; the SSM and hybrid families at the JAX
#: package's own decode-vs-forward tolerance
MODEL_TOL = {"bf16": (2e-2, 2e-2), "ssm": (0.1, 0.12)}
#: a router's k-th and (k+1)-th logits closer than this may rank either
#: way on two devices or two code paths: the logits are bf16, and this is
#: one unit of a logit below 8 in magnitude (two below 4); their
#: log-probabilities differ by as much as they do
ROUTE_TIE = 2**-5
#: at most this share of the rows routed may be such a tie replayed
ROUTE_TIE_SHARE = 0.01
#: part (b): qwen3-0.6b at full width through the serving driver, at its
#: defaults; its prefill's decode logits against ``forward_logits``
SERVE_MODEL_ARGV = ["--arch", "qwen3-0.6b", "--batch", "4", "--prompt-len", "32",
                    "--gen-len", "32", "--seed", "0"]
SERVE_MODEL_TOL = 5e-2
#: part (c): the other nine architectures at their published widths, cut
#: in depth only: where the f32 weights and their bf16 casts would not fit
#: the card (deepseek-v3: its three dense layers and one MoE layer), and
#: the SSM pair, held to the CPU, to a few layers (zamba2: one
#: shared-attention segment) for the CPU's time
WIDE_DEPTH = {"granite-20b": 4, "qwen2-moe-a2.7b": 4, "deepseek-v3-671b": 4, "qwen2-vl-72b": 4,
              "falcon-mamba-7b": 4, "zamba2-1.2b": 6}
#: architectures whose routed experts are held in bf16, the values every
#: path computes with (in f32, 42 GiB, their casts would not fit beside)
WIDE_BF16_EXPERTS = ("deepseek-v3-671b",)
#: part (c): the vision prefix's length (vlm)
WIDE_VISION = 16
#: part (c): the MoE pair's prompt.  The forward drops a token routed to
#: an expert past its capacity and a decode step (2 tokens) never does;
#: 2 x 4 tokens cannot fill the smallest capacity, 8 slots
WIDE_MOE_S = 4


def route_ties(probs, ids, want_probs, want_ids, k: int, *,
               hold: bool = True) -> tuple[int, float]:
    """The number of rows where two routers picked other top-``k``
    experts (``probs`` ``(T, E)`` and ``ids`` ``(T, k)`` of each, tensors
    or arrays), and the largest gap between the k-th and (k+1)-th
    log-probabilities of such a row in either; with ``hold``, raises
    unless every such row is a near tie (a gap below ``ROUTE_TIE``)."""
    import torch

    ids, want_ids = torch.as_tensor(ids).cpu(), torch.as_tensor(want_ids).cpu()
    differ = (ids.sort(dim=1)[0] != want_ids.sort(dim=1)[0]).any(dim=1)
    gap = 0.0
    for p in (probs, want_probs):
        top = torch.as_tensor(p).cpu().float()[differ].sort(dim=1, descending=True)[0].log()
        gap = max([gap, *(top[:, k - 1] - top[:, k]).tolist()])
    if hold and gap >= ROUTE_TIE:
        raise AssertionError(f"router: two runs pick other experts at a log-probability gap "
                             f"of {gap} (a near tie is below {ROUTE_TIE})")
    return int(differ.sum()), gap


def check_tie_share(label: str, ties: int, rows: int) -> None:
    """Raises if more than ``ROUTE_TIE_SHARE`` of ``rows`` routed rows
    were near ties replayed."""
    if ties > ROUTE_TIE_SHARE * rows:
        raise AssertionError(f"{label}: {ties} of {rows} routed rows replayed at a near tie "
                             f"(at most {ROUTE_TIE_SHARE:.0%})")


def _model_tol(cfg) -> tuple[float, float]:
    return MODEL_TOL["ssm" if cfg.family in ("ssm", "hybrid") else "bf16"]


def _model_inputs(cfg) -> dict:
    """Seeded numpy inputs of one smoke run (as the CPU tests make them):
    tokens, the stub frontends' embeddings, the decoder's memory."""
    rng = np.random.default_rng(1)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (MODEL_B, MODEL_S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = (rng.standard_normal((MODEL_B, 16, cfg.d_model)) * 0.02
                                ).astype(np.float32)
    if cfg.family == "encdec":
        out["src_embeds"] = (rng.standard_normal((MODEL_B, 2 * MODEL_S, cfg.d_model)) * 0.02
                             ).astype(np.float32)
        out["memory"] = (rng.standard_normal((MODEL_B, 8, cfg.d_model)) * 0.02
                         ).astype(np.float32)
    return out


def _model_batch(inputs: dict, dev) -> dict:
    """``_model_inputs`` as tensors on ``dev``: int32 tokens, bf16 embeddings."""
    import torch

    return {k: torch.from_numpy(v).to(dev, torch.int32 if v.dtype == np.int32 else torch.bfloat16)
            for k, v in inputs.items()}


def _model_run(model, net, inputs: dict, dev) -> dict:
    """``forward_logits``, ``forward_train``'s loss and ``MODEL_STEPS``
    decode steps of one model, as f32 tensors on the CPU."""
    import torch

    batch = _model_batch(inputs, dev)
    memory = batch.pop("memory", None)
    with torch.inference_mode():
        logits, _ = model.logits(net, batch)
        loss, _ = model.loss(net, batch)
        cache = model.init_cache(MODEL_B, MODEL_STEPS)
        steps = [model.decode_step(net, batch["tokens"][:, t:t + 1], cache, t, memory=memory)[0]
                 for t in range(MODEL_STEPS)]
    return {"logits": logits.float().cpu(), "loss": loss.float().cpu(),
            "decode": torch.cat(steps, dim=1).float().cpu()}


def _close(label: str, got, want, rtol: float, atol: float, rowwise: bool = False) -> float:
    """The largest absolute difference; raises past ``atol + rtol |want|``
    (``rowwise``: ``rtol`` times the largest ``|want|`` of the row, along
    the last dimension)."""
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs()
    scale = want.abs().amax(dim=-1, keepdim=True) if rowwise else want.abs()
    if got.shape != want.shape or not bool((err <= atol + rtol * scale).all()):
        raise AssertionError(f"{label}: the two runs differ, largest {float(err.max())} "
                             f"(rtol {rtol}, atol {atol}, shapes {tuple(got.shape)} / "
                             f"{tuple(want.shape)})")
    return float(err.max())


@contextlib.contextmanager
def _layer_hooks(on_layer, on_route):
    """Route every layer of the forwards and of the decode step through
    ``on_layer(run, x)`` (``run(x)`` is the layer on ``x``) and the MoE
    router through ``on_route(route, params, xt, cfg)``."""
    from repro_torch.models import moe, transformer

    apply_layer, decode_layer = transformer._apply_layer, transformer._decode_layer
    route = moe.route

    def forward(kind, lp, x, *args, **kw):
        aux = []

        def run(x_in):
            y, a = apply_layer(kind, lp, x_in, *args, **kw)
            aux.append(a)
            return y
        return on_layer(run, x), aux[-1]

    def decode(kind, lp, x, *args, **kw):
        return on_layer(lambda x_in: decode_layer(kind, lp, x_in, *args, **kw), x)

    transformer._apply_layer, transformer._decode_layer = forward, decode
    moe.route = lambda params, xt, cfg: on_route(route, params, xt, cfg)
    try:
        yield
    finally:
        transformer._apply_layer, transformer._decode_layer, moe.route = (
            apply_layer, decode_layer, route)


@contextlib.contextmanager
def _recording():
    """Every layer's ``(input, output)`` and every router's
    ``(probabilities, experts)`` of the runs inside, in call order."""
    layers, routes = [], []

    def on_layer(run, x):
        y = run(x)
        layers.append((x.clone(), y.clone()))
        return y

    def on_route(route, params, xt, cfg):
        probs, ids = route(params, xt, cfg)
        routes.append((probs.clone(), ids.clone()))
        return probs, ids

    with _layer_hooks(on_layer, on_route):
        yield layers, routes


@contextlib.contextmanager
def _forcing(layers, routes, tol, *, rowwise: bool = False, hold_routes: bool = True):
    """The runs inside with every layer fed the recorded input to it, its
    own input and its output held to the recorded ones at ``tol`` (by
    ``_close``, ``rowwise`` or not) and the recorded output passed on, and
    every router's experts replaced by the recorded ones, which
    (``hold_routes``) may differ from its own only at a near tie
    (``route_ties``).  Yields the largest layer difference, the rows where
    the experts differed, the largest gap of such a row and the rows
    routed, counted as the runs go."""
    stats = {"layer_max_abs_err": 0.0, "near_ties": 0, "tie_gap": 0.0, "routed_rows": 0}
    layers, routes = list(layers), list(routes)

    def on_layer(run, x):
        x_in, y_want = layers.pop(0)
        err = _close("layer input", x, x_in, *tol, rowwise)
        y = run(x_in.to(x.device, x.dtype))
        err = max(err, _close("layer output", y, y_want, *tol, rowwise))
        stats["layer_max_abs_err"] = max(stats["layer_max_abs_err"], err)
        return y_want.to(y.device, y.dtype)

    def on_route(route, params, xt, cfg):
        probs, ids = route(params, xt, cfg)
        want_probs, want_ids = routes.pop(0)
        ties, gap = route_ties(probs, ids, want_probs, want_ids, cfg.moe.top_k,
                               hold=hold_routes)
        stats["near_ties"] += ties
        stats["tie_gap"] = max(stats["tie_gap"], gap)
        stats["routed_rows"] += ids.shape[0]
        return probs, want_ids.to(ids.device)

    with _layer_hooks(on_layer, on_route):
        yield stats
    if layers or routes:
        raise AssertionError(f"{len(layers)} recorded layer calls and {len(routes)} router "
                             f"calls were not made again")


def _by_step(layers, routes, n_steps: int) -> tuple[list, list]:
    """A full-sequence forward's records cut into the decode steps' calls,
    in the decode's order: position ``t`` of every layer, then ``t + 1``."""
    step_layers = [(x[:, t:t + 1], y[:, t:t + 1]) for t in range(n_steps) for x, y in layers]
    step_routes = []
    for t in range(n_steps):
        for probs, ids in routes:
            step_routes.append((probs.reshape(MODEL_B, n_steps, -1)[:, t],
                                ids.reshape(MODEL_B, n_steps, -1)[:, t]))
    return step_layers, step_routes


def _smoke_arch(arch: str) -> dict:
    """Part (a): one architecture at its smoke config (``run_models``)."""
    import copy

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = get_config(arch, smoke=True)
    cpu_net = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    return _card_vs_cpu(arch, cfg, cpu_net, copy.deepcopy(cpu_net).to("cuda"),
                        hold_unforced=cfg.moe is None)


def _card_vs_cpu(label: str, cfg, cpu_net, card_net, *, hold_unforced: bool) -> dict:
    """One model's ``_model_run`` on the card held to the CPU's layer by
    layer, and end to end unforced: held with ``hold_unforced``, else
    measured (``run_models`` (a))."""
    import torch

    from repro_torch.models.model import Model

    tol = _model_tol(cfg)
    cpu_model, card_model = Model(cfg, "cpu"), Model(cfg)
    inputs = _model_inputs(cfg)
    t0 = time.perf_counter()
    with _recording() as (layers, routes):
        want = _model_run(cpu_model, cpu_net, inputs, "cpu")
    n_layers, n_routes = len(layers), len(routes)
    with _forcing(layers, routes, tol) as forced:
        got = _model_run(card_model, card_net, inputs, torch.device("cuda"))
    check_tie_share(f"{label} card vs CPU", forced["near_ties"], forced["routed_rows"])
    errs = {key: _close(f"{label} {key}", got[key], want[key], *tol) for key in want}
    free = _model_run(card_model, card_net, inputs, torch.device("cuda"))
    if hold_unforced:
        free_errs = {key: _close(f"{label} unforced {key}", free[key], want[key], *tol)
                     for key in want}
    else:
        free_errs = {key: float((free[key] - want[key]).abs().max()) for key in want}
        free_errs["one_unit_moves_logits"] = _one_unit_moves(card_model, card_net, inputs)
    out = {**forced, "max_abs_err": errs, "unforced_max_abs_err": free_errs,
           "unforced_held": hold_unforced, "layers": n_layers, "routers": n_routes,
           "wall_s": time.perf_counter() - t0}
    log(f"[models] {label}: card = CPU at rtol {tol[0]}, atol {tol[1]} over {n_layers} layer "
        f"calls and {n_routes} router calls ({forced['near_ties']} of "
        f"{forced['routed_rows']} rows replayed at a near tie); largest difference layer "
        f"{forced['layer_max_abs_err']:.4g}, logits {errs['logits']:.4g}, loss "
        f"{errs['loss']:.4g}, decode {errs['decode']:.4g}; unforced end to end "
        f"({'held' if hold_unforced else 'measured'}) logits {free_errs['logits']:.4g}, "
        f"loss {free_errs['loss']:.4g}, decode {free_errs['decode']:.4g}"
        + ("" if hold_unforced else f" (one bf16 unit of one input moves the card's logits "
                                    f"by {free_errs['one_unit_moves_logits']:.4g})")
        + f"; {out['wall_s']:.2f} s")
    return out


def _one_unit_moves(model, net, inputs: dict) -> float:
    """How far the card's logits move when one element of the first
    token's embedding moves by one bf16 unit: the spread that one
    rounding can grow to, end to end."""
    import torch

    batch = _model_batch(inputs, "cuda")
    batch.pop("memory", None)
    emb = net.embedding.embed
    tok = int(batch["tokens"][0, 0])
    with torch.no_grad():
        base, _ = model.logits(net, batch)
        old = emb[tok, 0].clone()
        emb[tok, 0] = (old.to(torch.bfloat16).view(torch.int16) + 1).view(torch.bfloat16).float()
        moved, _ = model.logits(net, batch)
        emb[tok, 0] = old
    return float((moved.float() - base.float()).abs().max())


def _serve_full() -> dict:
    """Part (b): qwen3-0.6b served at full width (``run_models``)."""
    import torch

    from repro_torch.launch import serve

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = serve.run(SERVE_MODEL_ARGV)
    peak = torch.cuda.max_memory_allocated()
    for line in serve.report(res):
        log(f"[models] serve: {line}")
    with torch.inference_mode():
        full, _ = res.model.logits(res.params, {"tokens": res.prompts})
    diff = (res.prefill_logits.float() - full.float()).abs()
    agree = float((res.prefill_logits.argmax(-1) == full.argmax(-1)).float().mean())
    max_err = _close("qwen3-0.6b prefill decode vs forward_logits", res.prefill_logits, full,
                     SERVE_MODEL_TOL, SERVE_MODEL_TOL)
    batch, gen_len = res.generated.shape
    # each row's first generated token comes from the prefill's last step
    n_decoded = batch * (gen_len - 1)
    cfg = res.model.cfg
    out = {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": sum(p.numel() for p in res.params.parameters()),
        "prefill_s": res.prefill_s, "decode_s": res.decode_s,
        "decode_tok_per_s": n_decoded / res.decode_s, "decoded_tokens": n_decoded,
        "generated_tokens": res.generated.numel(),
        "max_memory_allocated": peak, "prefill_vs_forward_max_abs_err": max_err,
        "argmax_agreement": agree, "mean_abs_err": float(diff.mean()),
    }
    log(f"[models] qwen3-0.6b full width ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{out['params']} parameters): prefill {res.prefill_s:.3f} s, decode "
        f"{res.decode_s:.3f} s for {n_decoded} decoded tokens "
        f"({out['decode_tok_per_s']:.1f} tok/s); max_memory_allocated {peak} B; prefill "
        f"decode logits vs forward_logits largest difference {max_err:.4g} (rtol = atol = "
        f"{SERVE_MODEL_TOL}), mean {out['mean_abs_err']:.4g}, argmax agreement {agree:.4f}")
    return out


def _wide_arch(arch: str) -> dict:
    """Part (c): one architecture at its published widths on the card
    (``run_models``)."""
    import copy

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.layers import as_tree
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import _encode

    cfg = get_config(arch)
    if arch in WIDE_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=WIDE_DEPTH[arch])
    # the MoE pair layer by layer at the bf16 tolerance; the rest end to
    # end at part (b)'s
    n_tok = WIDE_MOE_S if cfg.moe else MODEL_S
    tol = MODEL_TOL["bf16"] if cfg.moe else (SERVE_MODEL_TOL, SERVE_MODEL_TOL)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg)
    net = model.init(torch.Generator("cuda").manual_seed(0))
    if arch in WIDE_BF16_EXPERTS:
        for name, p in net.named_parameters():
            if ".moe.w_" in name:
                p.data = p.data.to(torch.bfloat16)
    if cfg.family in ("ssm", "hybrid"):
        # the forward's scan and conv round where the decode's recurrence
        # does not (in the JAX package too): at these widths the two part
        # by more than the SSM tolerance, so the card is held to the CPU
        # layer by layer; end to end, where falcon-mamba's rounding grows
        # past 0.1 / 0.12 over 4 layers, it is measured beside how far one
        # bf16 unit of one input moves the card's logits
        out = _card_vs_cpu(f"wide {arch}", cfg, copy.deepcopy(net).to("cpu"), net,
                           hold_unforced=False)
        out.update(n_layers=cfg.n_layers, d_model=cfg.d_model,
                   params=sum(p.numel() for p in net.parameters()),
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   wall_s=time.perf_counter() - t0)
        log(f"[models] wide {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{out['params']} parameters; max_memory_allocated "
            f"{out['max_memory_allocated']} B; {out['wall_s']:.2f} s")
        return out
    gen = torch.Generator("cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (MODEL_B, n_tok), generator=gen,
                           device="cuda", dtype=torch.int32)

    def embeds(n):  # a stub frontend's embeddings, as the smoke inputs
        return (torch.randn(MODEL_B, n, cfg.d_model, generator=gen, device="cuda")
                * 0.02).to(torch.bfloat16)

    batch, memory = {"tokens": tokens}, None
    stats = {}
    with torch.inference_mode():
        if cfg.family == "encdec":
            batch["src_embeds"] = embeds(2 * n_tok)
            memory = _encode(as_tree(net), cfg, batch["src_embeds"])
        recorder = _recording() if cfg.moe else contextlib.nullcontext(([], []))
        with recorder as (layers, routes):
            full, _ = model.logits(net, batch)
        cache = model.init_cache(MODEL_B, n_tok)
        # the decode's MLA attention is absorbed (another association in
        # bf16: a few units of the row's largest value apart), and its
        # router sees that difference: the forward's experts go on, and
        # the rows where the decode's own differ are counted, not held
        forcing = (_forcing(*_by_step(layers, routes, n_tok), tol, rowwise=True,
                            hold_routes=False) if cfg.moe
                   else contextlib.nullcontext(stats))
        with forcing as stats:
            decode = torch.cat([model.decode_step(net, tokens[:, t:t + 1], cache, t,
                                                  memory=memory)[0]
                                for t in range(n_tok)], dim=1)
        train = dict(batch)
        if cfg.family == "vlm":
            train["vision_embeds"] = embeds(WIDE_VISION)
            vis, _ = model.logits(net, train)
            finite = bool(torch.isfinite(vis).all())
            if vis.shape != (MODEL_B, WIDE_VISION + n_tok, cfg.vocab_size) or not finite:
                raise AssertionError(f"{arch}: the vision-prefixed forward gave "
                                     f"{tuple(vis.shape)}, finite {finite}")
        loss, metrics = model.loss(net, train)
    values = {"loss": loss, **metrics}
    if not all(bool(torch.isfinite(v)) for v in values.values()):
        raise AssertionError(f"{arch}: loss or its metrics not finite: "
                             f"{ {k: float(v) for k, v in values.items()} }")
    err = _close(f"{arch} full width, decode vs forward_logits", decode, full, *tol)
    agree = float((decode.argmax(-1) == full.argmax(-1)).float().mean())
    out = {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": sum(p.numel() for p in net.parameters()),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "decode_vs_forward_max_abs_err": err, "argmax_agreement": agree,
           "loss": float(loss), **stats, "wall_s": time.perf_counter() - t0}
    routed = (f"; layer by layer from the forward's inputs (rowwise), largest "
              f"{stats['layer_max_abs_err']:.4g}; the decode's own experts differ in "
              f"{stats['near_ties']} of {stats['routed_rows']} routed rows (largest gap "
              f"{stats['tie_gap']:.4g})" if cfg.moe else "")
    log(f"[models] wide {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{out['params']} parameters, {MODEL_B} x {n_tok} tokens; decode vs forward_logits at "
        f"rtol {tol[0]}, atol {tol[1]}, largest difference {err:.4g}, argmax agreement "
        f"{agree:.4f}{routed}; loss "
        f"{float(loss):.4f}; max_memory_allocated {out['max_memory_allocated']} B; "
        f"{out['wall_s']:.2f} s")
    del net, cache, full, decode
    return out


def run_models() -> dict:
    """Phase 1a. (a) Every architecture at its smoke config, seeded weights
    made on the CPU and copied to the card: ``forward_logits``,
    ``forward_train``'s loss and 8 decode steps on the card held to the
    CPU's layer by layer from the CPU's own input to each layer, with
    the CPU's experts where the routers disagree on a near tie (at most
    ``ROUTE_TIE_SHARE`` of the rows); then the same run unforced, end to
    end, held for the families without routing and measured for the MoE
    pair (one bf16 unit before a router can part a whole row: the JAX
    package's own deepseek-v3 smoke logits move by up to 0.086 under a
    one-unit change of one input). (b) qwen3-0.6b at full width served
    through ``repro_torch.launch.serve`` at its defaults: walls, tok/s,
    peak memory, and the prefill's decode logits against
    ``forward_logits`` on the same prompt. (c) The other nine at their
    published widths (``WIDE_DEPTH`` cuts depth only), weights drawn on
    the card: the SSM pair held to the CPU as in (a); the rest with the
    prompt through ``decode_step`` against ``forward_logits``, end to
    end, and for the MoE pair (``WIDE_MOE_S``) layer by layer from the
    forward's own input to each layer with the forward's experts
    replayed, each held to ``atol + rtol`` times its row's largest value
    (the decode's MLA attention is absorbed, another association in
    bf16; and where its router sees that difference, of 256 experts
    many rows lie within a bf16 unit: the rows where the decode's own
    experts differ are counted, not held);
    ``forward_train``'s loss finite, and the vision-prefixed forward.
    The substrate launches no hand kernel."""
    import torch

    from repro_torch.configs import list_configs
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    archs = {arch: _smoke_arch(arch) for arch in list_configs()}
    t_smoke = time.perf_counter() - t_phase
    serve_numbers = _serve_full()
    t_wide = time.perf_counter()
    wide = {arch: _wide_arch(arch) for arch in list_configs() if arch != "qwen3-0.6b"}
    t_wide = time.perf_counter() - t_wide
    launches = launch_counts()
    if any(launches.values()):
        raise AssertionError(f"the model substrate launched hand kernels: {launches}")
    wall = time.perf_counter() - t_phase
    log(f"[models] phase wall {wall:.1f} s (smoke archs {t_smoke:.1f} s, published widths "
        f"{t_wide:.1f} s)")
    out = {"archs": archs, "serve": serve_numbers, "wide": wide, "wall_s": wall}
    log(f"[models] json {json.dumps(out)}")
    torch.cuda.empty_cache()
    return {**out, "launches": launches}


# --------------------------------------------------------------------- #
# phase 1a (d): training (optim/, data/, train/, launch/train.py)
# --------------------------------------------------------------------- #
#: part (d) 1: three steps of each smoke config, batch, sequence, lr
TRAIN_STEPS, TRAIN_B, TRAIN_S, TRAIN_LR = 3, 4, 32, 1e-3
#: warmup_cosine(t, warmup=1, total=3) at t = 0, 1, 2: the first step
#: moves no parameter
TRAIN_LR_SCALES = (0.0, 1.0, 0.55)
#: each parameter leaf's change over the three steps, ``p_3 - p_0``, by
#: relative L2 error against the CPU's change (Adam's normalised update
#: passes a small gradient's relative error on undamped).  Sound runs on
#: an H100 read 0.0084-0.1005 a config at worst (deepseek-v3's
#: embedding), the CPU tests against the JAX package 0.0117-0.1042:
#: twice the largest is the bound.  A step that never writes the
#: parameters reads 1.
TRAIN_PARAM_DELTA_REL_L2 = 0.2
#: ``grad_norm``, the first moments and the compressed gradients by
#: relative L2 error, at the bound the CPU tests hold the port's
#: gradients to the JAX package's with; the second moments, averages of
#: squared gradients, at twice it (a square doubles a relative error)
TRAIN_REL_L2 = 5e-2
#: an int8 code's residual is at most half its quantisation step (the
#: leaf's largest magnitude over 127), f32 rounding aside
TRAIN_HALF_STEP = 0.5 + 2**-16
#: the variants: two microbatches for one dense config, int8 gradient
#: compression for another
TRAIN_VARIANTS = {"llama3.2-1b": {"microbatches": 2}, "qwen3-0.6b": {"grad_compression": True}}
#: part (d) 2: llama3.2-1b at full width through the training driver, at
#: its batch 8, sequence 128 and lr 3e-3, on the --kb-corpus stream (cut
#: from 20 steps to 10 after a smoke of 1,054.2 s, to keep it within its
#: time limit)
TRAIN_FULL_ARGV = ["--arch", "llama3.2-1b", "--kb-corpus", "--steps", "10"]
#: the stream's length: the JAX package's ``linearise_materialisation``
#: of ``lubm_like(20, 400, 40)`` at vocabulary 128,256 (as
#: ``DIST_EXPECTED``, the reference's own count)
KB_STREAM_TOKENS = 42_950
#: the kernels the corpus build's ``CMatEngine`` (not fused) launches
TRAIN_KERNELS = ("sorted_member", "join_bounds", "rle_expand")
#: part (d) 3: the JAX package's recovery test on the card
RECOVERY_STEPS, RECOVERY_EVERY, RECOVERY_FAIL_AT = 12, 3, (5, 9)
RECOVERY_TOL = {"rtol": 1e-5, "atol": 1e-6}


def _train_batches(cfg) -> list[dict]:
    """Three seeded numpy batches of part (d) 1: synthetic tokens, and the
    stub frontends' embeddings where the family has them."""
    from repro_torch.data import DataConfig, SyntheticCorpus

    corpus = SyntheticCorpus(DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0))
    rng = np.random.default_rng(2)
    out = []
    for step in range(TRAIN_STEPS):
        batch = {"tokens": corpus.batch(step)["tokens"]}
        if cfg.family == "vlm":
            batch["vision_embeds"] = (rng.standard_normal((TRAIN_B, 16, cfg.d_model)) * 0.02
                                      ).astype(np.float32)
        if cfg.family == "encdec":
            batch["src_embeds"] = (rng.standard_normal((TRAIN_B, 2 * TRAIN_S, cfg.d_model))
                                   * 0.02).astype(np.float32)
        out.append(batch)
    return out


def _norm(t) -> float:
    import torch

    return float(torch.linalg.vector_norm(t.detach().cpu().double()))


def _rel_l2(got, want) -> float:
    """``||got - want|| / ||want||`` (0 where both are zero)."""
    num = _norm(got.detach().cpu().double() - want.detach().cpu().double())
    den = _norm(want)
    return (0.0 if num == 0.0 else float("inf")) if den == 0.0 else num / den


def _route_recording():
    """Every router's ``(probabilities, experts)`` inside, in call order
    (the layers pass through; a remat'd recompute does not route)."""
    routes = []

    def on_route(route, params, xt, cfg):
        probs, ids = route(params, xt, cfg)
        routes.append((probs.clone(), ids.clone()))
        return probs, ids

    return _layer_hooks(lambda run, x: run(x), on_route), routes


def _route_replay(routes, stats: dict):
    """Every router's experts inside replaced by the recorded ones, which
    may differ from its own only at a near tie (``route_ties``)."""
    routes = list(routes)

    def on_route(route, params, xt, cfg):
        probs, ids = route(params, xt, cfg)
        want_probs, want_ids = routes.pop(0)
        ties, gap = route_ties(probs, ids, want_probs, want_ids, cfg.moe.top_k)
        stats["near_ties"] += ties
        stats["routed_rows"] += ids.shape[0]
        return probs, want_ids.to(ids.device)

    return _layer_hooks(lambda run, x: run(x), on_route), routes


def _train_smoke(arch: str, card: str = "cuda") -> dict:
    """Part (d) 1: three train steps of one smoke config on the card held
    to the same steps on the CPU (``run_train``; ``card`` names the
    device, the CPU in a rehearsal)."""
    import copy

    import torch

    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step, state_leaves

    t0 = time.perf_counter()
    cfg = get_config(arch, smoke=True)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=TRAIN_LR), warmup_steps=1,
                       total_steps=TRAIN_STEPS, **TRAIN_VARIANTS.get(arch, {}))
    step_fn = make_train_step(cfg, tcfg)
    cpu_state = init_train_state(torch.Generator().manual_seed(0), cfg, tcfg)
    card_state = _moved(copy.deepcopy(cpu_state), card)
    init = {k: v.detach().clone() for k, v in state_leaves(cpu_state["params"])}
    batches = _train_batches(cfg)
    recording, routes = _route_recording()
    with recording, _compression_records() as cpu_comp:
        want = [step_fn(cpu_state, _model_batch(b, "cpu"))[1] for b in batches]
    stats = {"near_ties": 0, "routed_rows": 0}
    replay, left = _route_replay(routes, stats)
    with replay, _compression_records() as card_comp:
        got = [step_fn(card_state, _model_batch(b, torch.device(card)))[1] for b in batches]
    if left:
        raise AssertionError(f"train {arch}: {len(left)} CPU router calls not made on the card")
    check_tie_share(f"train {arch} card vs CPU", stats["near_ties"], stats["routed_rows"])
    tol = _model_tol(cfg)
    errs = {"metrics": 0.0, "grad_norm": 0.0, "moments": 0.0, "params": 0.0, "params_leaf": "",
            "compressed_input": _check_compression(f"train {arch}", card_comp, cpu_comp)}
    for step, (g, w) in enumerate(zip(got, want)):
        if set(g) != set(w):
            raise AssertionError(f"train {arch} step {step}: metrics {sorted(g)} / {sorted(w)}")
        for key in w:
            if key == "grad_norm":
                err = _rel_l2(g[key], w[key])
                if not err <= TRAIN_REL_L2:
                    raise AssertionError(f"train {arch} step {step}: grad_norm {float(g[key])} "
                                         f"/ {float(w[key])}")
                errs["grad_norm"] = max(errs["grad_norm"], err)
            else:
                errs["metrics"] = max(errs["metrics"], _close(
                    f"train {arch} step {step} {key}", g[key], w[key], *tol))
    cpu_leaves, card_leaves = dict(state_leaves(cpu_state)), dict(state_leaves(card_state))
    for name, w in cpu_leaves.items():
        g = card_leaves[name]
        if name.startswith(("opt.mu", "opt.nu")):
            err = _rel_l2(g, w)
            if not err <= TRAIN_REL_L2 * (2 if name.startswith("opt.nu") else 1):
                raise AssertionError(f"train {arch}: {name} relative L2 error {err}")
            errs["moments"] = max(errs["moments"], err)
        elif name.startswith("params"):
            p0 = init[name[len("params."):]]
            err = _rel_l2(g.detach().cpu() - p0, w.detach() - p0)
            if not err <= TRAIN_PARAM_DELTA_REL_L2:
                raise AssertionError(f"train {arch}: {name}'s change relative L2 error {err}")
            if err > errs["params"]:
                errs["params"], errs["params_leaf"] = err, name
        elif name.startswith("error_feedback"):
            pass  # each step's, by _check_compression
        elif not torch.equal(g.cpu(), w):
            raise AssertionError(f"train {arch}: {name} {g} / {w}")
    out = {**errs, **stats, "variant": TRAIN_VARIANTS.get(arch, {}),
           "losses": [float(m["loss"]) for m in got], "wall_s": time.perf_counter() - t0}
    log(f"[train] {arch} {out['variant'] or ''}: {TRAIN_STEPS} steps card = CPU "
        f"(metrics at rtol {tol[0]}, atol {tol[1]}: largest {errs['metrics']:.4g}; "
        f"grad_norm {errs['grad_norm']:.4g}, mu/nu {errs['moments']:.4g} relative L2 of "
        f"{TRAIN_REL_L2} / {2 * TRAIN_REL_L2}; parameters' change {errs['params']:.4g} relative L2 "
        f"({errs['params_leaf']}) of {TRAIN_PARAM_DELTA_REL_L2}"
        + (f"; the compressed gradients {errs['compressed_input']:.4g} relative L2, "
           f"residuals within half a step" if "grad_compression" in out["variant"] else "")
        + f"; {stats['near_ties']} of {stats['routed_rows']} routed rows replayed at a near "
        f"tie); losses {', '.join(f'{x:.4f}' for x in out['losses'])}; {out['wall_s']:.2f} s")
    return out


def _moved(state, device):
    """The state tree (dicts, a module of parameters) on ``device``: its
    tensors copied there, a module moved in place."""
    import torch

    if isinstance(state, torch.nn.Module):
        return state.to(device)
    if isinstance(state, dict):
        return {k: _moved(v, device) for k, v in state.items()}
    return state.to(device)


@contextlib.contextmanager
def _compression_records():
    """Each step's ``{leaf: (g + e_old, e_new)}`` of the gradient
    compression inside: what is quantised (continuous in the gradients)
    and the residual left."""
    from repro_torch.train import train_step

    transform, records = train_step.compressed_grad_transform, []

    def recorded(grads, error_buf):
        out, err = transform(grads, error_buf)
        records.append({k: (grads[k].float() + error_buf[k], err[k]) for k in grads})
        return out, err

    train_step.compressed_grad_transform = recorded
    try:
        yield records
    finally:
        train_step.compressed_grad_transform = transform


def _check_compression(label: str, got: list, want: list) -> float:
    """Each step's quantised input held at ``TRAIN_REL_L2`` leaf by leaf,
    and on either side each residual within ``TRAIN_HALF_STEP`` of its
    quantisation step; returns the largest relative L2 error.  (The codes
    themselves are a rounding: a difference below one step moves them.)"""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} / {len(want)} compressed steps")
    worst = 0.0
    for step, (g, w) in enumerate(zip(got, want)):
        for name, (g32, _) in w.items():
            err = _rel_l2(g[name][0], g32)
            if not err <= TRAIN_REL_L2:
                raise AssertionError(f"{label} step {step}: compressed {name} relative L2 {err}")
            worst = max(worst, err)
            for side, (x, e) in (("card", g[name]), ("CPU", (g32, w[name][1]))):
                step_size = max(float(x.abs().max()) / 127.0, 1e-12)
                if float(e.abs().max()) > TRAIN_HALF_STEP * step_size:
                    raise AssertionError(f"{label} step {step}: {side} residual of {name} "
                                         f"{float(e.abs().max())} past half of {step_size}")
    return worst


def _train_full(argv: list[str] = TRAIN_FULL_ARGV) -> dict:
    """Part (d) 2: llama3.2-1b at full width through ``launch.train``
    (``run_train``; ``argv`` the driver's, another in a rehearsal)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.roofline.op_cost import count_ops

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build, corpus_launches, corpus_largest = train.build_kb_stream, {}, {}

    def counted(*args, **kwargs):
        stream = build(*args, **kwargs)
        torch.cuda.synchronize()
        corpus_launches.update(ops.launch_counts())
        corpus_largest.update(ops.largest_launches())
        return stream

    make_step, step_cost = train.make_train_step, {}

    def counting_step(cfg, train_cfg):
        """The driver's step, its first call (a warm-up, not timed) under
        ``count_ops`` (phase 1a (f))."""
        step = make_step(cfg, train_cfg)

        def call(state, batch):
            if step_cost:
                return step(state, batch)
            out, cost = count_ops(step, state, batch)
            step_cost.update(flops=cost.flops, hbm_bytes=cost.hbm_bytes,
                             bytes_written=cost.bytes_written, input_bytes=cost.input_bytes,
                             temp_bytes=cost.temp_bytes, n_ops=cost.n_ops,
                             batch_shape=list(batch["tokens"].shape))
            return out

        return call

    ops.reset_launch_counts()
    train.build_kb_stream, train.make_train_step = counted, counting_step
    try:
        res = train.run(argv)
    finally:
        train.build_kb_stream, train.make_train_step = build, make_step
    total = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_launches = {k: total[k] - corpus_launches[k] for k in total}
    if any(step_launches.values()):
        raise AssertionError(f"the train steps launched hand kernels: {step_launches}")
    missing = [k for k in TRAIN_KERNELS if not corpus_launches[k]]
    if missing:
        raise AssertionError(f"the corpus build never launched {missing}: {corpus_launches}")
    t0 = time.perf_counter()
    cpu_stream = train.build_kb_stream(res.cfg, res.corpus.cfg, "cpu")
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(res.corpus.tokens, cpu_stream.tokens):
        raise AssertionError("the card's KB token stream differs from the CPU's")
    if res.corpus.tokens.shape != (KB_STREAM_TOKENS,):
        raise AssertionError(f"the KB stream has {res.corpus.tokens.shape[0]} tokens, the JAX "
                             f"package's {KB_STREAM_TOKENS}")
    first, last = res.loss_trend()
    if not res.loss_fell:
        raise AssertionError(f"full-width training: the loss did not fall ({first} -> {last})")
    cfg = res.cfg
    walls = res.step_s[1:]
    step_s = statistics.median(walls)
    tokens = int(np.prod(res.corpus.batch(0)["tokens"].shape))
    out = {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "vocab_size": cfg.vocab_size,
        "params": sum(p.numel() for p in res.state["params"].parameters()),
        "steps": len(res.losses), "tokens_per_step": tokens, "step_s_median": step_s,
        "step_s": res.step_s, "tokens_per_s": tokens / step_s,
        "max_memory_allocated": peak, "losses": res.losses, "loss_first_last": [first, last],
        "corpus_s": res.corpus_s, "corpus_cpu_s": cpu_s, "stream_tokens": KB_STREAM_TOKENS,
        "corpus_launches": corpus_launches, "corpus_largest": corpus_largest,
        "step_launches": step_launches, "argv": list(argv), "step_cost": step_cost,
    }
    log(f"[train] {cfg.name} full width ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {out['params']} f32 parameters) through launch.train "
        f"{' '.join(argv)}: corpus build {res.corpus_s:.3f} s on the card "
        f"({KB_STREAM_TOKENS} tokens, equal to the CPU's, built there in {cpu_s:.3f} s; "
        f"launches {corpus_launches}, largest {corpus_largest}); step wall median {step_s:.4f} s over steps 2-"
        f"{len(res.losses)} ({out['tokens_per_s']:.1f} tokens/s at {tokens} tokens a step, "
        f"first step {res.step_s[0]:.3f} s); max_memory_allocated {peak} B; loss "
        f"{res.losses[0]:.4f} -> {res.losses[-1]:.4f} (first / last tenth {first:.4f} / "
        f"{last:.4f}); the steps launched no hand kernel")
    del res
    torch.cuda.empty_cache()
    return out


#: the cuBLAS workspace that deterministic algorithms require on the card
#: (32 MiB, the H100's default size): cuBLAS reads it once, at its first
#: call, so ``main`` sets it before touching the card
CUBLAS_WORKSPACE = ":4096:8"


@contextlib.contextmanager
def _deterministic():
    """``torch.use_deterministic_algorithms(True)`` inside, restored after
    (a cuBLAS call inside raises unless ``CUBLAS_WORKSPACE_CONFIG`` is
    ``CUBLAS_WORKSPACE``, as ``main`` sets it)."""
    import torch

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _train_recovery(card: str = "cuda") -> dict:
    """Part (d) 3: ``run_with_recovery`` on the card against two
    uninterrupted runs (``run_train``; ``card`` as for ``_train_smoke``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.train import (TrainConfig, init_train_state, make_train_step,
                                   run_with_recovery, state_leaves)

    t0 = time.perf_counter()
    cfg = get_config("llama3.2-1b", smoke=True)
    tcfg = TrainConfig(total_steps=RECOVERY_STEPS, warmup_steps=1)
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2))
    batches = [{k: torch.from_numpy(v).to(card) for k, v in corpus.batch(s).items()}
               for s in range(RECOVERY_STEPS)]
    step_fn = make_train_step(cfg, tcfg)

    def fresh():
        return init_train_state(torch.Generator(card).manual_seed(0), cfg, tcfg)

    def params(state):
        return [(k, v.detach().float().cpu()) for k, v in state_leaves(state["params"])]

    with _deterministic():
        runs = []
        for _ in range(2):
            state = fresh()
            for b in batches:
                state, _ = step_fn(state, b)
            runs.append(params(state))
        with tempfile.TemporaryDirectory() as d:
            state, last, failures = run_with_recovery(
                step_fn, fresh(), batches, ckpt_dir=d, ckpt_every=RECOVERY_EVERY,
                fail_at=set(RECOVERY_FAIL_AT))
    if (failures, last) != (len(RECOVERY_FAIL_AT), RECOVERY_STEPS):
        raise AssertionError(f"recovery: {failures} failures, last step {last}")
    spread = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(*runs))
    err = 0.0
    for (name, want), (_, got) in zip(runs[0], params(state)):
        err = max(err, _close(f"recovery {name}", got, want, RECOVERY_TOL["rtol"],
                              RECOVERY_TOL["atol"]))
    out = {"failures": failures, "last_step": last, "uninterrupted_spread": spread,
           "max_abs_err": err, "wall_s": time.perf_counter() - t0}
    log(f"[train] recovery on the card (deterministic algorithms): {RECOVERY_STEPS} steps, a "
        f"checkpoint every {RECOVERY_EVERY}, failures injected at {RECOVERY_FAIL_AT}: "
        f"{failures} recovered, the parameters against an uninterrupted run largest "
        f"difference {err:.4g} (rtol {RECOVERY_TOL['rtol']}, atol {RECOVERY_TOL['atol']}); "
        f"two uninterrupted runs apart by {spread:.4g}; {out['wall_s']:.2f} s")
    return out


def run_train() -> dict:
    """Phase 1a (d). (1) Every architecture at its smoke config, seeded
    state made on the CPU and copied to the card: three ``make_train_step``
    steps on the card held to the same steps on the CPU (llama3.2-1b with
    two microbatches, qwen3-0.6b with int8 gradient compression; the MoE
    pair with the CPU's experts replayed at near ties): each step's loss
    and metrics at the model tolerance, ``grad_norm`` and the moments
    after step 3 at ``TRAIN_REL_L2`` (the second moments at twice it),
    each parameter leaf's change over the steps at
    ``TRAIN_PARAM_DELTA_REL_L2``, each step's compressed gradient input
    at ``TRAIN_REL_L2`` and the residuals within half a quantisation
    step.  (2) llama3.2-1b at full width through
    ``repro_torch.launch.train`` on the ``--kb-corpus`` stream: the loss
    falls, the stream equals the CPU's and has ``KB_STREAM_TOKENS``
    tokens, the corpus build launches ``TRAIN_KERNELS`` and the steps no
    hand kernel; step wall, tokens/s, peak memory, losses, corpus wall.
    (3) ``run_with_recovery`` (12 steps, a checkpoint every 3, failures
    at steps 5 and 9) against an uninterrupted run at the JAX package's
    rtol 1e-5, atol 1e-6, under deterministic algorithms (the embedding's
    and the cross-entropy's backward accumulate with atomics otherwise)."""
    import torch

    from repro_torch.configs import list_configs

    t_phase = time.perf_counter()
    archs = {arch: _train_smoke(arch) for arch in list_configs()}
    t_smoke = time.perf_counter() - t_phase
    full = _train_full()
    recovery = _train_recovery()
    wall = time.perf_counter() - t_phase
    log(f"[train] phase wall {wall:.1f} s (smoke archs {t_smoke:.1f} s)")
    out = {"archs": archs, "full": full, "recovery": recovery, "wall_s": wall}
    log(f"[train] json {json.dumps(out)}")
    torch.cuda.empty_cache()
    return {**out, "launches": full["corpus_launches"]}


# --------------------------------------------------------------------- #
# phase 1a (e): sharding (launch/mesh.py, launch/sharding.py,
# models/sharding_policy.py, the MoE's EP path, reshard_state)
# --------------------------------------------------------------------- #
#: part (e) 1: the full-width steps, at the training driver's batch and
#: sequence, the plain state's and the placed state's in turn
SHARD_STEPS, SHARD_B, SHARD_S = 3, 8, 128
#: part (e) 2: the EP block's logical (data, model) layouts (60 experts
#: divide by 4; over 8 they pad to 64), and its input, batch x sequence
EP_LAYOUTS = ((2, 4), (2, 8))
EP_B, EP_S = 8, 128
#: the input's scale, the JAX package's EP test's: ``y`` is held at its
#: absolute 5e-2, a fraction of one bf16 unit at the outputs' magnitude
EP_X_SCALE = 0.1
#: the EP block's y against the gather path's, the JAX package's EP test
#: bound, and its aux at that rtol
EP_Y_TOL, EP_AUX_RTOL = 5e-2, 5e-2


def _sharded_train(arch: str = "llama3.2-1b", *, smoke: bool = False,
                   card: str = "cuda") -> dict:
    """Part (e) 1: ``SHARD_STEPS`` train steps of a plain state and of the
    same state placed by ``state_shardings`` on the 1x1 mesh (its batches
    by ``batch_shardings``), one run after the other (each state is four
    copies of the model): the losses and metrics at the model tolerance,
    ``grad_norm`` at ``TRAIN_REL_L2``, each parameter's change ``p_3 -
    p_0`` at ``TRAIN_PARAM_DELTA_REL_L2``; both runs' step walls."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.launch.sharding import batch_shardings, state_shardings
    from repro_torch.models.sharding_policy import set_policy_from_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainConfig, init_train_state, make_train_step,
                                   reshard_state, state_leaves)

    t_phase = time.perf_counter()
    cfg = get_config(arch, smoke=smoke)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=TRAIN_LR), warmup_steps=1,
                       total_steps=SHARD_STEPS)
    corpus = SyntheticCorpus(DataConfig(cfg.vocab_size, SHARD_S, SHARD_B, seed=0))
    batches = [{k: torch.from_numpy(v).to(card) for k, v in corpus.batch(s).items()}
               for s in range(SHARD_STEPS)]
    init_process_group(1, device=card)
    mesh = make_host_mesh(1, 1)
    set_policy_from_mesh(mesh)
    step_fn = make_train_step(cfg, tcfg)

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach()

    def run(placed: bool):
        state = init_train_state(torch.Generator(card).manual_seed(0), cfg, tcfg)
        p0 = {k: v.detach().clone() for k, v in state_leaves(state["params"])}
        if placed:
            state = reshard_state(state, mesh, state_shardings)
            if not all(isinstance(p, DTensor) for p in state["params"].parameters()):
                raise AssertionError("sharding: reshard_state left a parameter unplaced")
        metrics, walls = [], []
        for b in batches:
            if placed:
                sh = batch_shardings(b, mesh)
                b = {k: sh[k].place(v) for k, v in b.items()}
            _sync(card)
            t0 = time.perf_counter()
            state, m = step_fn(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
            walls.append(time.perf_counter() - t0)
        delta = {k: whole(v) - p0[k] for k, v in state_leaves(state["params"])}
        del state, p0
        _empty_cache(card)
        return metrics, walls, delta

    plain_m, plain_s, plain_d = run(False)
    placed_m, placed_s, placed_d = run(True)
    tol = _model_tol(cfg)
    err_metrics = err_gnorm = err_params = 0.0
    worst = ""
    for step, (g, w) in enumerate(zip(placed_m, plain_m)):
        for key in w:
            if key == "grad_norm":
                err = abs(g[key] - w[key]) / abs(w[key])
                if not err <= TRAIN_REL_L2:
                    raise AssertionError(f"sharding step {step}: grad_norm {g[key]} / {w[key]}")
                err_gnorm = max(err_gnorm, err)
            else:
                err_metrics = max(err_metrics, _close(
                    f"sharding step {step} {key}", torch.tensor(g[key]), torch.tensor(w[key]),
                    *tol))
    for k, w in plain_d.items():
        den = float(torch.linalg.vector_norm(w.double()))
        err = float(torch.linalg.vector_norm((placed_d[k] - w).double())) / den
        if not err <= TRAIN_PARAM_DELTA_REL_L2:
            raise AssertionError(f"sharding: {k}'s change relative L2 error {err}")
        if err >= err_params:
            err_params, worst = err, k
    out = {"arch": cfg.name, "d_model": cfg.d_model, "n_layers": cfg.n_layers,
           "vocab_size": cfg.vocab_size, "batch": SHARD_B, "seq": SHARD_S,
           "losses_plain": [m["loss"] for m in plain_m],
           "losses_placed": [m["loss"] for m in placed_m],
           "step_s_plain": plain_s, "step_s_placed": placed_s,
           "metrics_max_abs_err": err_metrics, "grad_norm_rel_err": err_gnorm,
           "params_delta_rel_l2": err_params, "params_delta_leaf": worst,
           "wall_s": time.perf_counter() - t_phase}
    log(f"[sharding] {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}), batch {SHARD_B} x {SHARD_S}: {SHARD_STEPS} steps of the state "
        f"placed on the 1x1 mesh (DTensor) = {SHARD_STEPS} plain steps (metrics largest "
        f"{err_metrics:.4g} at rtol {tol[0]}, atol {tol[1]}; grad_norm {err_gnorm:.4g} of "
        f"{TRAIN_REL_L2}; parameters' change {err_params:.4g} relative L2 ({worst}) of "
        f"{TRAIN_PARAM_DELTA_REL_L2}); losses plain "
        f"{', '.join(f'{x:.4f}' for x in out['losses_plain'])}, placed "
        f"{', '.join(f'{x:.4f}' for x in out['losses_placed'])}; step walls plain "
        f"{', '.join(f'{x:.3f}' for x in plain_s)} s, placed "
        f"{', '.join(f'{x:.3f}' for x in placed_s)} s")
    return out


def _sync(card) -> None:
    import torch

    if torch.device(card).type == "cuda":
        torch.cuda.synchronize()


def _empty_cache(card) -> None:
    import torch

    if torch.device(card).type == "cuda":
        torch.cuda.empty_cache()


def _ep_block(layout: tuple[int, int], *, smoke: bool = False, card: str = "cuda") -> dict:
    """Part (e) 2: one qwen2-moe-a2.7b MoE block (bf16) at ``capacity_factor``
    8 through the EP path for a logical (data, model) ``layout``, each
    shard's block run in turn and the model shards summed, against
    ``_moe_gather`` on the same input, one data shard's tokens at a time
    (the EP path's aux is the data shards' mean; neither path drops a
    token at this capacity, so a token's output does not depend on the
    tokens beside it): ``y`` at ``EP_Y_TOL``, ``aux`` at ``EP_AUX_RTOL``
    (also against the gather path's aux of the whole batch, as the JAX
    package's EP test holds it), each parameter's gradient of
    ``sum(y**2) + aux`` at ``TRAIN_REL_L2`` relative L2.  Each router
    then multiplies the same rows: the EP path's routers replay the
    gather's experts where the two split a near tie (``route_ties``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe, sharding_policy
    from repro_torch.models.layers import init_module_

    t0 = time.perf_counter()
    data, model = layout
    cfg = get_config("qwen2-moe-a2.7b", smoke=smoke)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    gen = torch.Generator(card).manual_seed(0)
    block = init_module_(moe.MoE(cfg, None, card), gen)
    leaves = {k: p.detach().requires_grad_(True) for k, p in block.named_parameters()}
    x = (torch.randn(EP_B, EP_S, cfg.d_model, generator=gen, device=card)
         * EP_X_SCALE).to(torch.bfloat16)

    def tree():
        t = {k: v.to(torch.bfloat16) for k, v in leaves.items() if "." not in k}
        t["shared"] = {k.split(".", 1)[1]: v.to(torch.bfloat16) for k, v in leaves.items()
                       if k.startswith("shared.")}
        return t

    def apply(blocks: int):
        _sync(card)
        t_run = time.perf_counter()
        ys, auxs = zip(*(moe.moe_apply(tree(), xb, cfg) for xb in x.split(EP_B // blocks)))
        y, aux = torch.cat(ys), torch.stack(auxs).mean()
        grads = torch.autograd.grad((y.float() ** 2).sum() + aux, list(leaves.values()))
        _sync(card)
        return y.detach(), aux.detach(), dict(zip(leaves, grads)), time.perf_counter() - t_run

    routes = []
    route = moe.route

    def record(params, xt, cfg):
        probs, ids = route(params, xt, cfg)
        routes.append((probs.detach(), ids))
        return probs, ids

    stats = {"near_ties": 0, "routed_rows": 0, "calls": 0}

    def replay(params, xt, cfg):
        probs, ids = route(params, xt, cfg)
        want_probs, want_ids = routes[stats["calls"] // model]
        stats["calls"] += 1
        ties, _ = route_ties(probs, ids, want_probs, want_ids, cfg.moe.top_k)
        stats["near_ties"] += ties
        stats["routed_rows"] += ids.shape[0]
        return probs, want_ids.to(ids.device)

    serial = moe._moe_ep_serial
    ep_calls = []

    def counted(*args):
        ep_calls.append(1)
        return serial(*args)

    prev = sharding_policy._POLICY
    try:
        sharding_policy.clear_policy()
        with torch.no_grad():
            aux_whole = moe.moe_apply(tree(), x, cfg)[1]
        moe.route = record
        y_g, aux_g, grads_g, gather_s = apply(data)
        sharding_policy.set_policy("data", "model", {"data": data, "model": model})
        moe.route, moe._moe_ep_serial = replay, counted
        y_e, aux_e, grads_e, ep_s = apply(1)
    finally:
        moe.route, moe._moe_ep_serial = route, serial
        sharding_policy._POLICY = prev
    if len(ep_calls) != 1 or stats["calls"] != data * model:
        raise AssertionError(f"EP {layout}: the EP path ran {len(ep_calls)} times, "
                             f"{stats['calls']} shard blocks")
    label = f"EP {data}x{model}"
    check_tie_share(label, stats["near_ties"], stats["routed_rows"])
    y_err = _close(f"{label} y", y_e, y_g, EP_Y_TOL, EP_Y_TOL)
    aux_err = abs(float(aux_e) - float(aux_g)) / abs(float(aux_g))
    aux_whole_err = abs(float(aux_e) - float(aux_whole)) / abs(float(aux_whole))
    if not max(aux_err, aux_whole_err) <= EP_AUX_RTOL:
        raise AssertionError(f"{label} aux {float(aux_e)} / {float(aux_g)} (by data shard) / "
                             f"{float(aux_whole)} (whole batch)")
    grad_err = {}
    for k, w in grads_g.items():
        grad_err[k] = float(torch.linalg.vector_norm((grads_e[k] - w).double())
                            / torch.linalg.vector_norm(w.double()))
        if not grad_err[k] <= TRAIN_REL_L2:
            raise AssertionError(f"{label} d/d{k}: relative L2 error {grad_err[k]}")
    n_model = -(-cfg.moe.n_experts // model) * model
    out = {"layout": list(layout), "experts": cfg.moe.n_experts, "padded_experts": n_model,
           "tokens": EP_B * EP_S, "y_max_abs_err": y_err,
           "aux": [float(aux_e), float(aux_g), float(aux_whole)], "aux_rel_err": aux_err,
           "aux_whole_rel_err": aux_whole_err, "grad_rel_l2": grad_err, **stats,
           "ep_s": ep_s, "gather_s": gather_s, "wall_s": time.perf_counter() - t0}
    log(f"[sharding] EP block ({cfg.name}: d_model {cfg.d_model}, {cfg.moe.n_experts} experts "
        f"padded to {n_model}, top-{cfg.moe.top_k}, d_expert_ff {cfg.moe.d_expert_ff}, "
        f"{cfg.moe.n_shared} shared; {EP_B * EP_S} bf16 tokens) at data {data} x model "
        f"{model}, the {data * model} shard blocks in turn, = the gather path by data shard: "
        f"y largest {y_err:.4g} (rtol = atol = {EP_Y_TOL}), aux {float(aux_e):.6g} / "
        f"{float(aux_g):.6g} ({aux_err:.3g} of {EP_AUX_RTOL}; whole batch "
        f"{float(aux_whole):.6g}, {aux_whole_err:.3g}), gradients' relative L2 "
        f"largest {max(grad_err.values()):.4g} ({max(grad_err, key=grad_err.get)}) of "
        f"{TRAIN_REL_L2}; {stats['near_ties']} of {stats['routed_rows']} routed rows replayed "
        f"at a near tie; forward + backward {ep_s:.3f} s (gather {gather_s:.3f} s)")
    return out


def run_sharding() -> dict:
    """Phase 1a (e). (1) llama3.2-1b at full width, its state placed on the
    1x1 mesh over NCCL by ``state_shardings`` (DTensors) and its batches
    by ``batch_shardings``: ``SHARD_STEPS`` steps against as many plain
    steps from the same seed (``_sharded_train``); (2) the EP block at
    qwen2-moe-a2.7b's published width for each of ``EP_LAYOUTS`` against
    the gather path (``_ep_block``); (3) no hand kernel launches."""
    import torch

    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    train = _sharded_train()
    ep = [_ep_block(layout) for layout in EP_LAYOUTS]
    torch.cuda.synchronize()
    launches = launch_counts()
    if any(launches.values()):
        raise AssertionError(f"sharding: the phase launched hand kernels: {launches}")
    out = {"train": train, "ep": ep, "launches": launches, "wall_s": time.perf_counter() - t0}
    log(f"[sharding] no hand kernel launched; phase wall {out['wall_s']:.1f} s")
    log(f"[sharding] json {json.dumps(out)}")
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- #
# phase 1a (f): the roofline of a real step (roofline/, launch/dryrun.py)
# --------------------------------------------------------------------- #
#: the dry run of one train step at a driver's config, batch and sequence
#: on the 1x1 mesh of meta DTensors (a fake group of one rank), as one
#: JSON record on the last line; argv: the driver's
DRYRUN_STEP = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, train
from repro_torch.launch.mesh import make_host_mesh

args = train._parse(sys.argv[1:])
cfg = get_config(args.arch, smoke=args.smoke)
shape = ShapeConfig("train_driver", args.seq, args.batch, "train")
print(json.dumps(dryrun.trace_cell(cfg, shape, lambda: make_host_mesh(1, 1), 1, mesh="1x1")))
"""


def start_step_dryrun(argv: list[str] = TRAIN_FULL_ARGV) -> subprocess.Popen:
    """The dry run of the training driver's step at ``argv``'s config and
    shape, started in a process of its own on the host (the fake group is
    a process's default group; it touches no card), its output in
    temporary files.  ``main`` starts it after phase 1a (e), so that no
    timed window of phases 1a-1a (e) shares the host with its trace: it
    runs beside phases 2-3, whose checks time nothing."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
    proc = subprocess.Popen([sys.executable, "-c", DRYRUN_STEP, *argv], env=env, cwd=ROOT,
                            stdout=out, stderr=err)
    proc.output_files = (out, err)
    return proc


def _roofline_counts(full: dict, proc: subprocess.Popen | None = None) -> dict:
    """The dry run's count of part (d) 2's step (``full``, from
    ``_train_full``; ``proc`` its :func:`start_step_dryrun`, started here
    if none) and the roofline row of the card's count against the
    step's measured wall.  Raises unless the card's counted FLOPs equal
    the dry run's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.roofline import analysis

    cost = full["step_cost"]
    args = train._parse(full["argv"])
    t0 = time.perf_counter()
    proc = proc or start_step_dryrun(full["argv"])
    proc.wait(timeout=300)
    stdout, stderr = (f.seek(0) or f.read().decode() for f in proc.output_files)
    if proc.returncode or proc.args[3:] != full["argv"]:
        raise RuntimeError(f"the dry run of the step {proc.args[3:]} failed: {stderr[-3000:]}")
    dry = json.loads(stdout.strip().splitlines()[-1])
    dry_s = time.perf_counter() - t0
    if dry["flops_per_device"] != cost["flops"]:
        raise AssertionError(f"the card counted {cost['flops']} FLOPs in a step, the 1x1 dry "
                             f"run {dry['flops_per_device']}")
    if dry["collective_total_per_device"]:
        raise AssertionError(f"the 1x1 dry run counted collectives: {dry}")
    cfg = get_config(args.arch, smoke=args.smoke)
    tokens = args.batch * args.seq
    if cost["batch_shape"] != [args.batch, args.seq]:
        raise AssertionError(f"the counted step's batch {cost['batch_shape']} is not the "
                             f"driver's {[args.batch, args.seq]}")
    wall = full["step_s_median"]
    row = analysis.RooflineRow(
        arch=cfg.name, shape=f"train {args.batch}x{args.seq}", mesh="1x1",
        compute_s=cost["flops"] / analysis.PEAK_FLOPS, memory_s=cost["hbm_bytes"] / analysis.HBM_BW,
        collective_s=0.0, model_flops_per_dev=6.0 * cfg.param_count() * tokens,
        hlo_flops_per_dev=cost["flops"], temp_bytes=cost["temp_bytes"])
    return {
        "arch": cfg.name, "batch": args.batch, "seq": args.seq, "card": cost,
        "dryrun": dry, "dryrun_s": dry_s, "step_s": wall,
        "compute_s": row.compute_s, "memory_s": row.memory_s, "bottleneck": row.bottleneck,
        "model_flops": row.model_flops_per_dev, "useful_ratio": row.useful_ratio,
        "roofline_fraction": row.roofline_fraction,
        "mfu": row.model_flops_per_dev / analysis.PEAK_FLOPS / wall,
        "counted_flops_share": cost["flops"] / analysis.PEAK_FLOPS / wall,
        "peak_flops": analysis.PEAK_FLOPS, "hbm_bw": analysis.HBM_BW,
        "table": analysis.format_table([row]),
    }


def run_roofline(train: dict, dryrun: subprocess.Popen | None = None) -> dict:
    """Phase 1a (f). (1) The FLOPs ``count_ops`` counted in the warm-up step
    of part (d) 2's full-width llama3.2-1b run on the card equal the dry
    run's count of the same step at the same shape on the 1x1 mesh of
    meta DTensors (:func:`_roofline_counts`; ``dryrun`` the process
    counting it, started after phase 1a (e) and run beside phases 2-3);
    (2) the roofline row of the
    card's count beside the step's measured median wall: the compute and
    memory terms over the H100's published peaks
    (``repro_torch.roofline.analysis``), the bottleneck, the model FLOPs
    (6 N T) over the peak over the wall, and the counted FLOPs over the
    peak over the wall, with the card's name and power limit.  The join
    bounds tuner's sweep runs in phase 9 (``sweep_join_bounds``)."""
    t0 = time.perf_counter()
    out = _roofline_counts(train["full"], dryrun)
    out["card_name_power"] = nvidia_smi()
    out["wall_s"] = time.perf_counter() - t0
    log(f"[roofline] {out['arch']} train step {out['batch']}x{out['seq']}: counted on the card "
        f"{out['card']['flops']:.6e} FLOPs, {out['card']['hbm_bytes']:.6e} B moved, peak live "
        f"{out['card']['temp_bytes']:.6e} B, {out['card']['n_ops']} ops; the 1x1 dry run "
        f"{out['dryrun']['flops_per_device']:.6e} FLOPs (equal), "
        f"{out['dryrun']['hbm_bytes_per_device']:.6e} B (traced in {out['dryrun']['trace_s']} s; "
        f"waited for {out['dryrun_s']:.1f} s here)")
    log(f"[roofline] against {out['peak_flops']:.4g} FLOP/s and {out['hbm_bw']:.4g} B/s "
        f"({out['card_name_power']}): compute {out['compute_s'] * 1e3:.4f} ms, memory "
        f"{out['memory_s'] * 1e3:.4f} ms, bottleneck {out['bottleneck']}; measured step "
        f"{out['step_s'] * 1e3:.4f} ms: model FLOPs {out['model_flops']:.6e} over peak over wall "
        f"{100 * out['mfu']:.3f} %, counted FLOPs over peak over wall "
        f"{100 * out['counted_flops_share']:.3f} %")
    for line in out["table"].splitlines():
        log(f"[roofline] {line}")
    log(f"[roofline] phase wall {out['wall_s']:.1f} s, smoke total so far "
        f"{time.perf_counter() - _T0:.1f} s")
    log(f"[roofline] json {json.dumps(out)}")
    return out


# --------------------------------------------------------------------- #
# phase 9: kernels against their plain versions
# --------------------------------------------------------------------- #
def _distinct(rng, n, hi):
    """Exactly ``n`` distinct integers in ``[0, hi)``, in random order."""
    if n > hi:
        raise ValueError(f"no {n} distinct integers below {hi}")
    x = np.unique(rng.integers(0, hi, size=n + n // 8 + 16))
    while x.shape[0] < n:
        x = np.unique(np.concatenate([x, rng.integers(0, hi, size=n)]))
    return rng.permutation(x)[:n]


def _search_inputs(n, m, dtype, dev, rng, keys="random"):
    """``(a, b)``: ``m`` sorted keys ``b`` and ``n`` probes ``a`` in random
    order.  ``random``: distinct keys, half the probes keys of ``b``, half
    uniform over the key type's range.  ``runs``: as the CMat xjoin
    probes, ``n`` distinct keys that ``b`` holds ``m / n`` times each on
    average.  ``15-bit``: as the distributed engine joins, keys below
    2^15, ``b`` half real keys and half the sentinel padding of its join
    capacity."""
    import torch

    if keys == "runs":
        return _main_path_case("cmat-xjoin", {"n": n, "m": m}, dtype, dev, rng)
    if keys == "15-bit":
        from repro_torch.kernels import ref

        b = np.concatenate([np.sort(rng.integers(0, 2**15, size=m // 2)),
                            np.full(m - m // 2, ref.sentinel(dtype))])
        a = rng.integers(0, 2**15, size=n)
    else:
        hi = 2**31 - 2 if dtype == torch.int32 else 2**62
        b = np.sort(_distinct(rng, m, hi))
        a = rng.permutation(np.concatenate([b[rng.integers(0, m, size=n // 2)],
                                            rng.integers(0, hi, size=n - n // 2)]))
    return (torch.as_tensor(a).to(dtype=dtype, device=dev),
            torch.as_tensor(b).to(dtype=dtype, device=dev))


def _cases(name, shape, dtype, dev, rng):
    """``(label, args, timed)`` cases of one kernel: seeded inputs at the
    operand lengths ``shape`` of its largest main-path launch (timed) and
    the edge cases."""
    import torch

    from repro_torch.kernels import ref

    big = ref.sentinel(dtype)
    hi = 2**31 - 2 if dtype == torch.int32 else 2**62

    def t(x):
        return torch.as_tensor(np.asarray(x)).to(dtype=dtype, device=dev)

    def sorted_t(x):
        return t(np.sort(x))

    def pad(x, k):
        return torch.cat([x, torch.full((k,), big, dtype=dtype, device=dev)])

    empty = t(np.zeros(0, dtype=np.int64))
    if name == "fused_join_dedup":
        return _join_cases(shape, t, sorted_t, pad, empty, rng)
    if name in ("sorted_member", "join_bounds"):
        a, b = _search_inputs(shape["n"], shape["m"], dtype, dev, rng)
        small_b = sorted_t(_distinct(rng, 100, 1000))
        small_a = t(rng.integers(0, 1000, size=300))
        cases = [
            ("full", (a, b), True),
            ("empty-a", (empty, small_b), False),
            ("empty-b", (small_a, empty), False),
            ("sentinel-padding", (pad(small_a, 64), pad(small_b, 29)), False),
            ("all-sentinel", (pad(empty, 50), pad(empty, 7)), False),
        ]
        if name == "sorted_member":
            # m = 1; duplicates in b; sentinel padding after a long b (one
            # gap across almost every bucket); n not a multiple of the four
            # probes a thread takes; operands that do not start on a
            # 16-byte boundary; few probes into a long b (few, wide
            # buckets); two far clusters of keys with probes between them
            # (buckets whose starts the table kernel skips)
            dup_b = sorted_t(rng.integers(0, 3000, size=200_000))
            clusters = np.concatenate([np.arange(5000), hi - 5000 + np.arange(5000)])
            cases += [
                ("m-1", (small_a, small_b[50:51].contiguous()), False),
                ("duplicates-in-b", (t(rng.integers(0, 3100, size=20_003)), dup_b), False),
                ("sentinel-padding-long-b", (pad(t(rng.integers(0, 3100, size=20_000)), 64),
                                             pad(dup_b, 5000)), False),
                ("n-ragged", (small_a[:299].contiguous(), small_b), False),
                ("unaligned-views", (small_a[2:], small_b[3:]), False),
                ("few-probes", (small_a[:50].contiguous(), dup_b), False),
                ("few-probes-sentinel", (pad(small_a[:20].contiguous(), 5), pad(dup_b, 5000)),
                 False),
                ("clustered-keys", (t(np.concatenate([clusters[::7], rng.integers(0, hi, 2000)])),
                                    t(clusters)), False),
            ]
        if name == "join_bounds":
            # two far clusters of r with probes in the long gap between them
            # (buckets no key falls in, whose starts must still be exact);
            # probes below r[0] and above r[m - 1]; all of r equal (one
            # bucket); m = 1; duplicates in l; n not a multiple of the four
            # keys a thread takes and views off a 16-byte boundary; runs of
            # duplicates in r longer than a bucket
            clusters = np.concatenate([np.arange(5000), hi - 5000 + np.arange(5000)])
            mid_r = sorted_t(rng.integers(hi // 3, 2 * hi // 3, size=3000))
            outside = np.concatenate([rng.integers(0, hi // 3, size=500),
                                      rng.integers(2 * hi // 3, hi, size=500)])
            runs = sorted_t(np.repeat(rng.integers(0, 3000, size=300), 70))
            # few left keys against many right ones (the warp path), most
            # of them below r[0] or above r[m - 1]
            wide_r = sorted_t(rng.integers(hi // 3, 2 * hi // 3, size=200_000))
            wide_l = np.concatenate([outside[:800], wide_r[::1000].cpu().numpy()])
            # a dense run of keys, then 40 keys spread over the rest of the
            # span: 40 gaps of more than 1,024 buckets among one table
            # block's keys, more than the block lists (its warps fill the
            # rest), probed mostly inside the gaps
            sparse_r = np.concatenate([np.arange(139_960), np.linspace(2**20, hi - 1, 40).astype(np.int64)])
            sparse_l = np.concatenate([rng.integers(0, hi, size=39_000),
                                       rng.integers(0, 139_960, size=1_000)])
            # the distributed engine's sides: 15-bit keys, the right side
            # padded with the sentinel to its join capacity (2^18), invalid
            # left rows probing big - 1
            dist_r = pad(sorted_t(rng.integers(0, 2**15, size=80_000)), (1 << 18) - 80_000)
            dist_l = t(np.concatenate([rng.integers(0, 2**15, size=30_000),
                                       np.full(500, big - 1), np.full(77, big)]))
            cases += [
                ("sentinel-padded-r", (dist_l[torch.randperm(dist_l.shape[0], device=dev)],
                                       dist_r), False),
                ("gap-probes", (t(np.concatenate([rng.integers(5000, hi - 5000, 3000),
                                                  clusters[::7]])), t(clusters)), False),
                ("out-of-span", (t(np.concatenate([outside, mid_r[::5].cpu().numpy()])), mid_r),
                 False),
                ("all-r-equal", (t(rng.integers(0, 20, size=1001)), t(np.full(4096, 10))), False),
                ("m-1", (small_a, small_b[50:51].contiguous()), False),
                ("duplicates-in-l", (t(np.repeat(rng.integers(0, 1000, size=50), 40)), small_b),
                 False),
                ("n-ragged", (small_a[:299].contiguous(), small_b), False),
                ("unaligned-views", (small_a[2:], small_b[3:]), False),
                ("long-runs-in-r", (t(rng.integers(0, 3100, size=20_003)), runs), False),
                ("out-of-span-few-keys", (t(wide_l), wide_r), False),
                ("many-long-gaps", (t(sparse_l), sorted_t(sparse_r)), False),
            ]
        return cases
    if name == "rle_expand":
        r, total = shape["runs"], shape["total"]
        vals = sorted_t(rng.integers(0, hi, size=r))
        counts = torch.as_tensor(rng.multinomial(total, [1 / r] * r)).to(dev)
        # one run holds 90 % of total, the rest spread evenly: the skewed
        # pair enumeration of a join key matched by most pairs
        heavy = (total * 9 + 9) // 10
        skew = rng.multinomial(total - heavy, [1 / r] * r)
        skew[r // 2] += heavy
        small_v = t(rng.integers(0, 1000, size=50))
        small_c = torch.as_tensor(rng.integers(0, 5, size=50)).to(dev)
        # zero-length stretches at the start, in the middle and at the end
        zc = np.zeros(3000, dtype=np.int64)
        zc[700:760] = rng.integers(1, 40, size=60)
        zc[2000] = 5000
        zv = t(rng.integers(0, hi, size=3000))
        # int32 counts whose total is odd: the tail tile ends mid-vector
        ragged = torch.full((50,), 163, dtype=torch.int32, device=dev)
        ragged[-1] = 164
        return [
            ("full", (vals, counts, total), True),
            ("skewed", (vals, torch.as_tensor(skew).to(dev), total), True),
            ("zero-runs", (small_v, small_c, int(small_c.sum())), False),
            ("one-run", (small_v[:1], small_c[:1] + 7, int(small_c[0]) + 7), False),
            ("empty", (empty, empty.to(torch.int64), 0), False),
            ("zero-stretches", (zv, torch.as_tensor(zc).to(dev), int(zc.sum())), False),
            ("one-run-many-tiles", (small_v[:3], torch.tensor([2, 20_001, 1], device=dev),
                                    20_004), False),
            ("ragged-tail", (small_v, ragged, 50 * 163 + 1), False),
        ]
    # merge_sorted_unique: ``count`` codes already buffered, ``fresh``
    # distinct codes disjoint from them, as the fused tail's survivors are
    cap, nb, nf = shape["cap"], shape["count"], shape["fresh"]
    pool = _distinct(rng, nb + nf, hi)
    buf = pad(sorted_t(pool[:nb]), cap - nb)
    fresh = sorted_t(pool[nb:])
    small_old = sorted_t(_distinct(rng, 100, 1000))
    small_buf = pad(small_old, 128 - small_old.shape[0])
    # 20 values already in buf plus exactly enough new ones to fill it
    n_room = 128 - small_old.shape[0]
    exact_fill = torch.unique(
        torch.cat([small_old[:20], t(np.arange(1000, 1000 + n_room))])
    )
    # runs of equal fresh values longer than a merge tile (7,936 int32 or
    # 3,840 int64 positions), so tiles start and end inside them
    run_fresh = sorted_t(np.repeat(_distinct(rng, 40, hi), 9000))
    run_buf = pad(sorted_t(_distinct(rng, 3000, hi)), 5192)
    # fresh inside a large buf: every value dropped, a hole [total, nb + f)
    # far longer than a tile
    big_old = sorted_t(_distinct(rng, 100_000, hi))
    # the cut at cap falls inside a tile
    cut_old = sorted_t(_distinct(rng, 5000, hi // 2))
    return [
        ("full", (buf, fresh), True),
        ("empty-buf-empty-fresh", (pad(empty, 128), empty), False),
        ("all-sentinel-buf", (pad(empty, 128), small_old), False),
        ("duplicates", (small_buf, small_old[::3].contiguous()), False),
        ("fills-exactly", (small_buf, exact_fill), False),
        ("truncates", (small_buf, t(np.arange(2000, 2200))), False),
        ("padded-fresh", (small_buf, pad(small_old[1::2].contiguous(), 9)), False),
        ("runs-across-tiles", (run_buf, run_fresh), False),
        ("fresh-inside-buf", (pad(big_old, 162_144), big_old[1::2].contiguous()), False),
        ("cut-mid-tile", (pad(cut_old, 12_800 - 5000),
                          sorted_t(hi // 2 + _distinct(rng, 10_000, hi // 2))), False),
        ("cap-far-above-inputs", (pad(small_old, (1 << 20) - 100), t(np.arange(2000, 2200))),
         False),
    ]


#: the main path's own launches that the synthetic ``full`` cases miss
#: (CMat ``lubm_like(500, 1_000_000, 10_000)``, ``_xjoin_head_rows``): the
#: largest, whose left keys (1,000 values) all lie above the right keys
#: (1,000,000 values), and the one whose right keys repeat its 10,000
#: distinct left keys
CMAT_DISJOINT = {"n": 3_993_727, "m": 3_993_727, "l_values": 1_000, "r_values": 1_000_000}
CMAT_XJOIN = {"n": 10_000, "m": 2_999_718}
#: the closure's first capacity, before a regrow
CLOSURE_FIRST_CAPACITY = 4096


def _main_path_case(label, shape, dtype, dev, rng):
    """``(l_keys, r_sorted)`` of a ``join_bounds`` launch as the CMat run
    gives it (``CMAT_DISJOINT``, ``CMAT_XJOIN`` or a smaller copy)."""
    import torch

    n, m = shape["n"], shape["m"]

    def t(x):
        return torch.as_tensor(np.asarray(x)).to(dtype=dtype, device=dev)

    if label == "cmat-disjoint":
        nl, nr = shape["l_values"], shape["r_values"]
        # right keys: every one of nr values at least once, in [501, 501 + nr)
        r = np.sort(np.concatenate([np.arange(nr), rng.integers(0, nr, size=m - nr)])) + 501
        l = rng.integers(0, nl, size=n) + 501 + nr
        return t(l), t(r)
    # cmat-xjoin: n distinct left keys, the right keys over the same values
    keys = _distinct(rng, n, 10 * n) + 501
    counts = rng.multinomial(m - n, [1 / n] * n) + 1
    return t(keys), t(np.sort(np.repeat(keys, counts)))


#: rows per key of a snapshot column the query path searches with one
#: key (``lubm_like``'s 10,000 courses over 3,000,000 ``takesCourse`` rows)
QUERY_KEY_RUN = 300
#: a long candidate slice for one residual constant: a constant that a
#: million rows hold
QUERY_LONG_SLICE = 1 << 20


def _query_case(label, shape, dtype, dev, rng):
    """The query path's one-sided launches at full length.
    ``query-one-key``: ``join_bounds`` of one key (``n = 1``) that the
    sorted column holds, against ``m`` keys in runs of about
    ``QUERY_KEY_RUN``, as ``SortedRows.count_eq`` / ``eq_slice`` search a
    snapshot column.  ``query-one-constant``: ``sorted_member`` of ``n``
    candidates, about half of them the constant, against that one
    constant (``m = 1``), as ``in_set`` filters a slice by a residual
    constant."""
    import torch

    def t(x):
        return torch.as_tensor(np.asarray(x)).to(dtype=dtype, device=dev)

    if label == "query-one-key":
        m = shape["m"]
        n_keys = max(1, m // QUERY_KEY_RUN)
        keys = np.sort(_distinct(rng, n_keys, 2**31 - 2))
        counts = rng.multinomial(m - n_keys, [1 / n_keys] * n_keys) + 1
        return t(keys[n_keys // 2: n_keys // 2 + 1]), t(np.repeat(keys, counts))
    n = shape["n"]
    c = int(rng.integers(0, 2**31 - 2))
    a = np.where(rng.random(n) < 0.5, c, rng.integers(0, 2**31 - 2, size=n))
    return t(a), t([c])


def _timed_args(name, label, shape, dtype, dev, rng):
    """The inputs of one timed case: a main-path launch of
    :func:`_main_path_case`, or the ``full`` case of :func:`_cases` at
    ``shape``."""
    if label in ("cmat-disjoint", "cmat-xjoin"):
        return _main_path_case(label, shape, dtype, dev, rng)
    if label in ("query-one-key", "query-one-constant"):
        return _query_case(label, shape, dtype, dev, rng)
    if label.startswith("closure-"):
        return _closure_case(shape, dev)
    (args,) = [a for lab, a, _ in _cases(name, shape, dtype, dev, rng) if lab == "full"]
    return args


def _rows(facts, atom, dev):
    """``atom``'s relation in ``facts`` as int32 rows on ``dev`` (none
    when it holds no fact)."""
    import torch

    rows = facts.get(atom.predicate, torch.zeros((0, atom.arity), dtype=torch.int64))
    return rows.to(dev, torch.int32)


def closure_joins(program, facts, dev):
    """``(rule, args)`` of every two-atom rule of ``program`` whose head
    pairs a left-only and a right-only variable: ``args`` are
    ``fused_join_dedup``'s ``[l_keys, l_payload, r_keys_sorted,
    r_payload]`` over the shared variable, from ``facts`` (sorted unique
    rows per predicate, as ``DistributedEngine.to_dict`` and the flat
    oracle give them)."""
    import torch

    def col(rows, atom, var):
        return rows[:, atom.terms.index(var)].contiguous()

    for rule in program:
        if len(rule.body) != 2 or rule.head.arity != 2:
            continue
        a, b = rule.body
        x, z = rule.head.terms
        shared = set(a.variables()) & set(b.variables())
        if x not in a.variables() or x in shared or z not in b.variables() or z in shared:
            continue
        (k,) = shared
        left, right = _rows(facts, a, dev), _rows(facts, b, dev)
        r_keys, order = torch.sort(col(right, b, k), stable=True)
        yield rule, [col(left, a, k), col(left, a, x), r_keys,
                     col(right, b, z)[order].contiguous()]


@functools.lru_cache(maxsize=2)
def _kb_facts(kb: tuple) -> tuple:
    """``lubm_like(**dict(kb))``'s program as the distributed engine runs
    it and its flat oracle's materialisation on the CPU (about 0.1 s at
    ``DIST_KB``), sorted unique rows per predicate."""
    from repro_torch.core.distributed import DistributedEngine
    from repro_torch.core.flat import flat_seminaive
    from repro_torch.core.generators import lubm_like
    from repro_torch.core.util import unique_rows

    program, dataset, _ = lubm_like(**dict(kb))
    program = DistributedEngine.supported_program(program)
    facts = flat_seminaive(program, dataset, device="cpu")
    return program, {p: unique_rows(r) for p, r in facts.items()}


def _closure_case(shape, dev):
    """The inputs of one of the closure's own launches, as
    :func:`run_closure` records it (its KB, head predicate, lengths and
    capacity), rebuilt from the flat oracle of that KB."""
    (args,) = [a for rule, a in closure_joins(*_kb_facts(tuple(sorted(shape["kb"].items()))), dev)
               if rule.head.predicate == shape["head"]]
    if (args[0].shape[0], args[2].shape[0]) != (shape["n"], shape["m"]):
        raise AssertionError(f"closure case {shape}: the oracle's join is "
                             f"{args[0].shape[0]} x {args[2].shape[0]}")
    return (*args, shape["capacity"])


def _join_cases(shape, t, sorted_t, pad, empty, rng):
    """``fused_join_dedup`` cases: the timed one at the largest closure
    join's lengths and pair count (15-bit payloads), and the edge cases."""
    n, m, cap = shape["n"], shape["m"], shape["capacity"]
    l_keys, r_keys = _join_keys(n, m, shape["pairs"], rng)
    n_pairs = int((np.searchsorted(r_keys, l_keys, "right")
                   - np.searchsorted(r_keys, l_keys, "left")).sum())
    if min(n_pairs, cap) != shape["pairs"]:
        raise AssertionError(f"timed join gives {n_pairs} pairs, not {shape['pairs']}")
    l_keys, r_keys = t(l_keys), t(r_keys)
    l_pay, r_pay = t(rng.integers(0, 2**15, size=n)), t(rng.integers(0, 2**15, size=m))
    sl, sr = t(rng.integers(0, 50, size=300)), sorted_t(rng.integers(0, 50, size=200))
    slp, srp = t(rng.integers(0, 2**15, size=300)), t(rng.integers(0, 2**16, size=200))

    def full(k, v):
        return t(np.full(k, v))

    # one key matched 3000 x 300 times: 900 k pairs over many sort tiles,
    # 30 k distinct codes
    skew = (full(3000, 7), t(np.arange(3000)), full(300, 7), t(np.arange(300) % 10))
    # payloads past 15 bits: codes wrap to negative int32, the sort's top
    # digit must keep them below the positive ones (about 30 k pairs)
    wl, wr = t(rng.integers(0, 3000, size=30_000)), sorted_t(rng.integers(0, 3000, size=3000))
    wide = (wl, t(rng.integers(0, 2**16, size=30_000)), wr, t(rng.integers(0, 2**20, size=3000)))
    return [
        ("full", (l_keys, l_pay, r_keys, r_pay, cap), True),
        ("empty-left", (empty, empty, sr, srp, 64), False),
        ("empty-right", (sl, slp, empty, empty, 64), False),
        ("zero-capacity", (sl, slp, sr, srp, 0), False),
        ("all-duplicates", (full(37, 5), full(37, 9), full(11, 5), full(11, 3), 512), False),
        ("cut-capacity", (l_keys, l_pay, r_keys, r_pay, n // 3), False),
        ("sentinel-left-keys", (pad(sl, 40), pad(slp, 40), pad(sr, 5), pad(srp, 5), 4096), False),
        ("disjoint-keys", (sl + 100, slp, sr, srp, 64), False),
        ("skewed-key", (*skew, 1 << 20), False),
        ("wide-payloads", (*wide, 1 << 16), False),
        # the regrow's first call at the largest launch: only the first
        # 4,096 pairs in left-major order may enter the sort
        ("closure-cut", (l_keys, l_pay, r_keys, r_pay, CLOSURE_FIRST_CAPACITY), False),
    ]


def _join_keys(n, m, pairs, rng):
    """Left keys ``(n,)`` and sorted right keys ``(m,)`` whose join gives
    exactly ``pairs`` pairs.  With ``q, r = divmod(pairs, n)``, ``r`` left
    rows each name one of ``h`` heavy keys held ``q + 1`` times on the
    right and the others one of ``l`` light keys held ``q`` times (none:
    a miss, at ``q == 0``); the remaining right rows hold keys no left row
    names.  At ``pairs == n`` each right key is held once, as a course has
    one teacher."""
    q, r = divmod(pairs, n)
    h = min(r, m) if not q else max(1, min(r, m // 2 // (q + 1))) if r else 0
    rest = m - h * (q + 1)
    l = min(n - r, 1000) if not q else min(n - r, max(rest, 0) // q)
    if (r and not h) or not l or rest < l * q:
        raise ValueError(f"no join of {n} x {m} rows gives {pairs} pairs")
    keys = _distinct(rng, h + l + rest - l * q, 2**31 - 2)
    heavy, light, spare = keys[:h], keys[h:h + l], keys[h + l:]
    right = np.concatenate([np.repeat(heavy, q + 1), np.repeat(light, q), spare])
    left = np.concatenate([heavy[rng.integers(0, max(h, 1), size=r)],
                           light[rng.integers(0, l, size=n - r)]])
    return rng.permutation(left), np.sort(right)


def _as_list(out):
    return list(out) if isinstance(out, tuple) else [out]


def _sector_bytes(t, at):
    """Bytes of the 32-byte sectors of ``t`` that hold the positions ``at``
    (an int tensor; positions outside ``t`` ignored), at most all of
    ``t``."""
    import torch

    m, size = t.shape[0], t.element_size()
    at = at.to(torch.int64)
    at = at[(at >= 0) & (at < m)]
    sectors = torch.unique((t.data_ptr() % 32 + at * size) // 32).shape[0]
    return min(m * size, 32 * sectors)


def _deciding_bytes(keys, bounds):
    """Bytes of the sorted ``keys`` that any search must read to certify
    the positions ``bounds`` (an int tensor of lower or upper bounds): the
    keys on either side of each, in the 32-byte sectors that hold them, at
    most all of ``keys``.  A key outside the span needs only an end."""
    import torch

    return _sector_bytes(keys, torch.cat([bounds - 1, bounds]))


def _join_bytes(l_keys, l_pay, r_keys, r_pay, cap):
    """Bytes ``fused_join_dedup`` must move: every left key; of the right
    keys only the sectors that decide each left row's span (a sentinel key
    matches nothing and needs none); the payloads only of the rows whose
    pairs fall in the first ``cap`` in left-major order; ``cap`` codes and
    the count written."""
    import torch

    from repro_torch.kernels import ref

    live = torch.nonzero(l_keys != ref.sentinel(l_keys.dtype)).flatten()
    lo = torch.searchsorted(r_keys, l_keys[live])
    hi = torch.searchsorted(r_keys, l_keys[live], right=True)
    take = torch.clamp(torch.minimum(hi - lo, cap - (torch.cumsum(hi - lo, 0) - (hi - lo))),
                       min=0)
    # the right rows of the kept pairs: lo .. lo + take - 1 of each row
    first = torch.cumsum(take, 0) - take
    r_rows = (torch.arange(int(take.sum()), device=lo.device)
              + torch.repeat_interleave(lo - first, take))
    size = l_keys.element_size()
    return (l_keys.shape[0] * size + _deciding_bytes(r_keys, torch.cat([lo, hi]))
            + _sector_bytes(l_pay, live[take > 0]) + _sector_bytes(r_pay, r_rows)
            + cap * size + 4)


def _bytes(name, args, dtype_size):
    """Bytes the function must move: each input read once, each output
    written once; of the sorted side of a search only what decides the
    answers (:func:`_deciding_bytes`), of a join's payloads only those of
    the pairs it keeps (:func:`_join_bytes`), from this run's data."""
    import torch

    if name == "sorted_member":
        a, b = args
        deciding = _deciding_bytes(b, torch.searchsorted(b, a))
        return a.shape[0] * dtype_size + deciding + a.shape[0]
    if name == "join_bounds":
        a, b = args
        deciding = _deciding_bytes(b, torch.cat([torch.searchsorted(b, a),
                                                 torch.searchsorted(b, a, right=True)]))
        return a.shape[0] * dtype_size + deciding + 8 * a.shape[0]
    if name == "rle_expand":
        vals, counts, total = args
        return vals.shape[0] * (dtype_size + counts.element_size()) + total * dtype_size
    if name == "fused_join_dedup":
        return _join_bytes(*args)
    # only buf's occupied prefix is read; the merge writes all of buf's
    # length and two int64 stats
    buf, fresh = args
    from repro_torch.kernels import ref

    nb = int((buf != ref.sentinel(buf.dtype)).sum())
    return (nb + fresh.shape[0] + buf.shape[0]) * dtype_size + 16


#: what each kernel's ``library_ms`` times, printed beside it
LIBRARY_CALLS = {
    "sorted_member": "torch.searchsorted",
    "join_bounds": "torch.searchsorted, left and right",
    "rle_expand": "torch.repeat_interleave",
    "merge_sorted_unique": "torch.unique of torch.cat",
    "fused_join_dedup": "torch.unique of the packed pairs: the sort-and-dedup "
                        "half only, as no call computes the join",
}


def _library_call(name, args):
    """The PyTorch call that computes the same function, or the named part
    of it (``LIBRARY_CALLS``); timed as a yardstick only, the port never
    calls it."""
    import torch

    if name == "sorted_member":
        a, b = args
        return lambda: torch.searchsorted(b, a)
    if name == "join_bounds":
        a, b = args
        return lambda: (torch.searchsorted(b, a), torch.searchsorted(b, a, right=True))
    if name == "rle_expand":
        vals, counts, total = args
        return lambda: torch.repeat_interleave(vals, counts, output_size=total)
    if name == "fused_join_dedup":
        from repro_torch.kernels import ref

        codes, _ = ref.join_pairs16(*args)
        return lambda: torch.unique(codes)
    buf, fresh = args
    return lambda: torch.unique(torch.cat([buf, fresh]))


#: kernels timed in both key types (the others in their main-path type)
BOTH_KEY_TYPES = ("sorted_member", "rle_expand")


def main_path_call(name, kernel, args):
    """``kernel`` on ``args`` as the main path calls it: the merge with
    ``count``, the number of codes ``buf`` holds, as ``FactBuffers``
    passes it (counted once here)."""
    if name != "merge_sorted_unique":
        return lambda: kernel(*args)
    from repro_torch.kernels import ref

    buf, fresh = args
    count = int((buf != ref.sentinel(buf.dtype)).sum())
    return lambda: kernel(buf, fresh, count=count)


#: the kernels of each ``join_bounds`` path, as the profiler names them
PATH_KERNELS = {
    "table": ("join_bounds_table_kernel", "join_bounds_probe_kernel"),
    "warp": ("join_bounds_warp_kernel",),
    "thread": ("join_bounds_thread_kernel",),
}
#: the one kernel of a ``fused_join_dedup`` call, as the profiler names it
JOIN_KERNEL = "fjd_kernel"
#: profiler traces taken, at most, for a check of which kernels ran
TRACE_TRIES = 3


def _check_equal(name, label, dtype, kernel, plain, args) -> int:
    """Hold one kernel call against its plain version exactly (the merge
    both with and without ``count``; ``join_bounds`` by the path its sizes
    pick and by each of its paths, checking under the profiler which
    kernels each ran); returns the largest absolute difference (0)."""
    want = _as_list(plain(*args))
    calls = [lambda: kernel(*args)]
    if name == "merge_sorted_unique":
        calls.append(main_path_call(name, kernel, args))
    if name == "join_bounds":
        from repro_torch.kernels.join_bounds import PATHS, join_bounds_by

        calls += [lambda p=p: join_bounds_by(*args, p) for p in PATHS]
    err = 0
    for call in calls:
        err = max(err, _compare(name, label, dtype, _as_list(call()), want))
    if name == "join_bounds":
        _check_paths_ran(label, dtype, args, calls)
    if name == "fused_join_dedup":
        _check_join_ran(label, args, calls[0])
    log(f"[kernels] {name} {str(dtype)[6:]} {label}: equal")
    return err


def _check_paths_ran(label, dtype, args, calls) -> None:
    """Profiled runs of a ``join_bounds`` case's calls (the routed one, then
    one per path) must have run exactly the kernels of those paths, none
    where a side is empty (counts per run rounded: the profiler may drop
    the first kernel of its trace).  The kernels run are fixed by the
    inputs, so a trace that shows others lost events (the card's host
    drops some now and then): it is taken again, up to ``TRACE_TRIES``
    times in all."""
    from repro_torch.kernels.join_bounds import PATHS, route

    n, m = args[0].shape[0], args[1].shape[0]
    routed = route(n, m, args[0].dtype, args[0].device)
    want = dict.fromkeys(k for ks in PATH_KERNELS.values() for k in ks)
    for k in want:
        want[k] = sum(k in PATH_KERNELS[p] for p in (routed, *PATHS)) if n and m else 0
    for _ in range(TRACE_TRIES):
        _, ran = device_ms(lambda: [c() for c in calls], reps=5)
        got = {k: round(sum(c for key, c in ran.items() if k in key)) for k in want}
        if got == want:
            return
    raise AssertionError(f"join_bounds {dtype} {label} ({n} x {m}, routed "
                         f"{routed}): kernels run {got}, not {want}")


def _check_join_ran(label, args, call) -> None:
    """Profiled ``fused_join_dedup`` calls must each have launched the
    kernel once (the launch meter, which counts a launch once the entry has
    queued it and read its total without error), and the profiler must show
    no other kernel (memsets and copies aside) and at most one of it a call
    (it may drop a short trace's kernels); at capacity 0 nothing runs.  A
    trace that fails this is taken again, up to ``TRACE_TRIES`` times in
    all, as in :func:`_check_paths_ran`."""
    from repro_torch.kernels import ops

    n, m, cap = args[0].shape[0], args[2].shape[0], args[4]
    calls = 0

    def counted():
        nonlocal calls
        calls += 1
        return call()

    for _ in range(TRACE_TRIES):
        calls = 0
        before = ops.launch_counts()["fused_join_dedup"]
        _, ran = device_ms(counted, reps=5)
        launched = ops.launch_counts()["fused_join_dedup"] - before
        kernels = {k: c for k, c in ran.items() if not k.startswith(("Memset", "Memcpy"))}
        ours = sum(c for k, c in kernels.items() if JOIN_KERNEL in k)
        others = sum(c for k, c in kernels.items() if JOIN_KERNEL not in k)
        if launched == (calls if cap else 0) and round(ours) <= 1 and not (cap and round(others)):
            return
    raise AssertionError(f"fused_join_dedup {label} ({n} x {m}, capacity {cap}): "
                         f"{launched} launches metered, kernels run {kernels}")


def _compare(name, label, dtype, got, want) -> int:
    """The largest absolute difference of equal outputs; raises unless
    every output equals its plain counterpart."""
    import torch

    torch.cuda.synchronize()
    err = 0
    for g, w in zip(got, want):
        if not isinstance(g, torch.Tensor):  # a host total
            if g != w:
                raise AssertionError(f"{name} {dtype} {label}: kernel total {g} != plain {w}")
            continue
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{name} {dtype} {label}: kernel != plain version")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def _kernels_per_call(device_ops: dict[str, float]) -> float:
    """Kernels a call ran, from :func:`device_ms`'s counts: copies and sets
    are not kernels."""
    return sum(c for k, c in device_ops.items() if not k.startswith(("Memset", "Memcpy")))


def _tuned_against_hand_set(label, dtype, args) -> dict:
    """The path the tuner routes a timed ``join_bounds`` case to
    (``route`` on the card) and the hand-set rule's: where they differ,
    each path's device-only time (:func:`device_ms`, the best of two runs
    each, in turns: tuned, hand-set, hand-set, tuned).  Raises where the
    tuned path is the slower: the tuner may only make the main path's
    launches faster."""
    from repro_torch.kernels import tune
    from repro_torch.kernels.join_bounds import join_bounds_by, route

    l_keys, r_sorted = args
    n, m = l_keys.shape[0], r_sorted.shape[0]
    tuned = route(n, m, l_keys.dtype, l_keys.device)
    hand = tune.default_blocks("join_bounds", n)["path"] if m else "warp"
    out = {"tuned_path": tuned, "hand_set_path": hand}
    if tuned == hand or not n:
        return out
    times = {tuned: [], hand: []}
    for path in (tuned, hand, hand, tuned):
        ms = device_ms(lambda: join_bounds_by(l_keys, r_sorted, path))[0]
        if ms is not None:
            times[path].append(ms)
    if not times[tuned] or not times[hand]:
        raise AssertionError(f"join_bounds {label}: no device time traced for {times}")
    out.update(tuned_device_ms=min(times[tuned]), hand_set_device_ms=min(times[hand]))
    log(f"[kernels] join_bounds {str(dtype)[6:]} {label} ({n} x {m}): tuned path {tuned} "
        f"{out['tuned_device_ms']} ms, hand-set {hand} {out['hand_set_device_ms']} ms "
        f"on the device")
    if out["tuned_device_ms"] > out["hand_set_device_ms"]:
        raise AssertionError(f"join_bounds {label} ({n} x {m}): the tuned path {tuned} is "
                             f"slower than the hand-set {hand}: {out}")
    return out


def _time_case(name, label, dtype, shape, kernel, plain, args) -> dict:
    """Every time of one timed case: kernel and library call in
    alternating turns (event-timed medians), their device-only times under
    the profiler, the kernel's host time per call, the plain version's
    time, and the bytes bound of these inputs."""
    from repro_torch.roofline.analysis import HBM_BW

    library = _library_call(name, args)
    call = main_path_call(name, kernel, args)
    ms, library_ms = alternating_ms(call, library)
    kernel_device_ms, device_ops = device_ms(call)
    # every fused_join_dedup call launches its kernel (the launch meter
    # counts it): a trace showing less than one a call lost events (the
    # card's host drops some now and then), so it is taken again, up to
    # TRACE_TRIES times in all, as in _check_paths_ran
    for _ in range(TRACE_TRIES - 1):
        if name != "fused_join_dedup" or round(_kernels_per_call(device_ops)) >= 1:
            break
        kernel_device_ms, device_ops = device_ms(call)
    entry = {
        "case": label,
        "dtype": str(dtype)[6:],
        "shape": dict(shape),
        "ms": ms,
        "library_ms": library_ms,
        "device_ms": kernel_device_ms,
        "device_ops_per_call": device_ops,
        "library_device_ms": device_ms(library)[0],
        "host_ms": host_ms(call),
        "plain_ms": cuda_ms(lambda: plain(*args)),
        "bound_ms": _bytes(name, args, dtype.itemsize) / HBM_BW * 1e3,
        "bound_by": "bytes",
    }
    if name == "join_bounds":
        entry.update(_tuned_against_hand_set(label, dtype, args))
    log(f"[kernels] {name} {entry['dtype']} {label} {shape}: {entry}")
    # the merge as the main path calls it is one kernel (two only when it
    # must find how many codes buf holds), never with a library scan;
    # copies and sets are not kernels
    kernels = _kernels_per_call(device_ops)
    if name == "merge_sorted_unique" and (
        kernels > 1 or any("Scan" in k or "cumsum" in k for k in device_ops)
    ):
        raise AssertionError(f"merge_sorted_unique {label}: device work per call {device_ops}")
    # the join is one kernel (a memset before it and the total's copy after
    # it aside), no library scan or sort; the profiler may drop the first
    # kernel of its trace, so a call reads at most one
    if name == "fused_join_dedup" and (
        round(kernels) != 1 or any(w in k for k in device_ops
                                   for w in ("Scan", "cumsum", "Sort", "sort", "unique"))
    ):
        raise AssertionError(f"fused_join_dedup {label}: device work per call {device_ops}")
    return entry


def check_kernels(dev, shapes: dict[str, dict[str, int]],
                  extra: dict[str, list] | None = None) -> dict[str, dict]:
    """Every kernel against its plain version; ``shapes`` are the operand
    lengths of each kernel's largest launch on the full-size run, and
    ``extra`` maps a kernel to more ``(label, shape, dtypes)`` launches to
    time (the ``full`` case of :func:`_cases` at that shape)."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import ops, ref

    wrappers = {
        "sorted_member": (kernels.sorted_member, ref.sorted_member),
        "join_bounds": (kernels.join_bounds, ref.join_bounds),
        "rle_expand": (kernels.rle_expand, ref.rle_expand),
        "merge_sorted_unique": (kernels.merge_sorted_unique, ref.merge_sorted_unique),
        "fused_join_dedup": (kernels.fused_join_dedup, ref.fused_join_dedup),
    }
    extra = extra or {}
    results = {}
    for name, (kernel, plain) in wrappers.items():
        err = 0
        timings = []
        # fused_join_dedup exists for the TPU's int32 codes only; the others
        # are timed in int64, the fused engine's key type, and two of them
        # in int32 as well
        dtypes = (torch.int32,) if name == "fused_join_dedup" else (torch.int32, torch.int64)
        for dtype in dtypes:
            rng = np.random.default_rng([ops.KERNELS.index(name), dtype.itemsize])
            for label, args, timed in _cases(name, shapes[name], dtype, dev, rng):
                err = max(err, _check_equal(name, label, dtype, kernel, plain, args))
                if timed and (dtype == dtypes[-1] or name in BOTH_KEY_TYPES):
                    timings.append(_time_case(name, label, dtype, shapes[name],
                                              kernel, plain, args))
        for label, shape, extra_dtypes in extra.get(name, ()):
            for dtype in extra_dtypes:
                rng = np.random.default_rng([ops.KERNELS.index(name), dtype.itemsize, 1])
                args = _timed_args(name, label, shape, dtype, dev, rng)
                err = max(err, _check_equal(name, label, dtype, kernel, plain, args))
                timings.append(_time_case(name, label, dtype, shape, kernel, plain, args))
        # the line's own numbers: the main-path launch in its key type
        (main,) = [t for t in timings
                   if t["case"] == "full" and t["dtype"] == str(dtypes[-1])[6:]]
        results[name] = dict(main, max_abs_err=err, timings=timings)
    return results


#: ``join_bounds`` path sweep, ``(keys, n, m)`` (:func:`_search_inputs`):
#: random keys at equal sides from 2^16 to 2^22 and at 2^22 right keys
#: against 2^12 to 2^18 left keys (around ``WARP_KEYS`` and
#: ``THREAD_KEYS``), the CMat xjoin's runs of equal keys around
#: ``WARP_KEYS``, and the distributed engine's 15-bit keys at equal sides
#: around ``THREAD_KEYS``
PATH_SWEEP = ([("random", 1 << k, 1 << k) for k in (16, 17, 18, 19, 20, 22)]
              + [("random", 1 << k, 1 << 22) for k in (12, 13, 14, 16, 18)]
              + [("runs", 1 << k, 1 << 22) for k in (12, 13, 14, 15, 16)]
              + [("15-bit", 1 << k, 1 << k) for k in (17, 18, 19)])


@contextlib.contextmanager
def _tune_cache(path: Path):
    """The join_bounds tuner reads and writes ``path`` inside (its
    in-process mirror dropped on entry and on exit)."""
    from repro_torch.kernels import tune

    saved = os.environ.get(TUNE_CACHE_ENV)
    os.environ[TUNE_CACHE_ENV] = str(path)
    tune._cache = None
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(TUNE_CACHE_ENV, None)
        else:
            os.environ[TUNE_CACHE_ENV] = saved
        tune._cache = None


def sweep_join_bounds(dev) -> list[dict]:
    """Every ``join_bounds`` path at each :data:`PATH_SWEEP` point, in both
    key types: each held against the plain version, then event-timed
    (:func:`cuda_ms`) and timed on the device alone (:func:`device_ms`);
    and the path the tuner (``kernels/tune.py``, its cache in a temporary
    directory, empty at the start) picks there beside the hand-set rule's
    (``route`` off the card): the first ``get_blocks`` of a size bucket
    sweeps it, a second at the same point must be a cache hit."""
    import torch

    from repro_torch.kernels import ops, ref, tune
    from repro_torch.kernels.join_bounds import PATHS, join_bounds_by
    from repro_torch.obs import get_registry

    reg = get_registry()
    points = []
    with tempfile.TemporaryDirectory() as tmp, _tune_cache(Path(tmp) / "sweep.json"):
        for dtype in (torch.int32, torch.int64):
            rng = np.random.default_rng([ops.KERNELS.index("join_bounds"), dtype.itemsize, 3])
            for keys, n, m in PATH_SWEEP:
                l, r = _search_inputs(n, m, dtype, dev, rng, keys)
                want = ref.join_bounds(l, r)
                reg.reset("kernels.tune.")
                tuned = tune.get_blocks("join_bounds", dtype, n, m=m, device=dev)["path"]
                swept = reg.snapshot("kernels.tune.").get("kernels.tune.sweeps", 0)
                again = tune.get_blocks("join_bounds", dtype, n, m=m, device=dev)["path"]
                hits = reg.snapshot("kernels.tune.").get("kernels.tune.cache_hits", 0)
                if again != tuned or hits != 1 + (not swept):
                    raise AssertionError(f"tune: {n} {dtype} gave {tuned} then {again}, "
                                         f"{hits} cache hits")
                point = {"keys": keys, "n": n, "m": m, "dtype": str(dtype)[6:],
                         "routed": tune.default_blocks("join_bounds", n)["path"],
                         "tuned": tuned, "swept": bool(swept),
                         "bucket": f"{tune.size_bucket(n)}x{tune.size_bucket(m)}"}
                for path in PATHS:
                    call = lambda p=path: join_bounds_by(l, r, p)  # noqa: E731
                    _compare("join_bounds", f"sweep {n} x {m} {path}", dtype, list(call()), want)
                    point[path] = {"ms": cuda_ms(call), "device_ms": device_ms(call, reps=10)[0]}
                log(f"[sweep] join_bounds {point}")
                points.append(point)
                del l, r, want
    return points


def _count_syncs(call):
    """``(result, host synchronisations)`` of ``call()`` under CUDA's
    sync debug mode."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return result, sum("synchroniz" in str(w.message) for w in caught)


# --------------------------------------------------------------------- #
# phases 2 and 4: the engine
# --------------------------------------------------------------------- #
def _facts_equal(got: dict, want: dict) -> bool:
    import torch

    return set(got) == set(want) and all(
        torch.equal(got[p].cpu(), want[p].cpu()) for p in want
    )


def check_small_workloads() -> None:
    from repro_torch.core import CMatEngine
    from repro_torch.core.generators import bipartite, chain, lubm_like, paper_example, star

    workloads = [
        ("paper", lambda: paper_example(n=30, m=20)),
        ("chain", lambda: chain(n=60)),
        ("lubm", lambda: lubm_like(n_dept=4, n_students=60, n_courses=10)),
        ("star", lambda: star(n_spokes=80, n_hubs=3)),
        ("bipartite", lambda: bipartite(n_left=30, n_right=30)),
    ]
    fields = ("rounds", "n_meta_facts", "n_facts", "rule_applications_skipped")
    for name, gen in workloads:
        program, dataset, _ = gen()
        runs = {}
        for device in ("cuda", "cpu"):
            eng = CMatEngine(program, fused=True, device=device)
            eng.load(dataset)
            stats = eng.materialise()
            runs[device] = (eng.materialisation(), [getattr(stats, f) for f in fields])
        if not _facts_equal(runs["cuda"][0], runs["cpu"][0]):
            raise AssertionError(f"small {name}: fact sets differ (card vs CPU)")
        if runs["cuda"][1] != runs["cpu"][1]:
            raise AssertionError(f"small {name}: stats differ {runs['cuda'][1]} vs {runs['cpu'][1]}")
        log(f"[small] {name}: equal, {dict(zip(fields, runs['cuda'][1]))}")
        check_small_provenance(name, program, dataset, runs["cuda"][0])


def run_full(program, dataset) -> dict:
    import torch

    from repro_torch.core import CMatEngine
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng = CMatEngine(program, fused=True)  # the default device: the card
    eng.load(dataset)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats = eng.materialise()
    torch.cuda.synchronize()
    t_mat = time.perf_counter() - t0
    launches = launch_counts()
    largest = ops.largest_launches()
    out = {
        "load_s": t_load,
        "materialise_s": t_mat,
        "rounds": stats.rounds,
        "n_meta_facts": stats.n_meta_facts,
        "n_facts": stats.n_facts,
        "rule_applications_skipped": stats.rule_applications_skipped,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "largest_launch": largest,
        "engine": eng,
    }
    log(f"[full] load {t_load:.3f} s, materialise {t_mat:.3f} s, rounds "
        f"{stats.rounds}, n_meta_facts {stats.n_meta_facts}, n_facts "
        f"{stats.n_facts}, max_memory_allocated {out['max_memory_allocated']}")
    log(f"[full] materialise host time by phase (s): compress "
        f"{stats.time_compress:.3f}, match {stats.time_match:.3f}, join "
        f"{stats.time_join:.3f}, dedup {stats.time_dedup:.3f}")
    log(f"[full] launches {launches}")
    log(f"[full] largest launch per kernel (operand lengths) {largest}")
    missing = [k for k, v in launches.items() if v == 0 and k != "fused_join_dedup"]
    if missing:
        raise AssertionError(f"full run never launched: {missing}")
    if "count" not in largest["merge_sorted_unique"]:
        raise AssertionError("the merge's launch meter lacks the buffered count")
    return out


# --------------------------------------------------------------------- #
# phases 3 and 5: queries
# --------------------------------------------------------------------- #
#: ``tests/test_query.py``'s query lists
LUBM_QUERIES = [
    '?s, ?c <- memberOf(?s, "dept3"), takesCourse(?s, ?c)',
    "?s, ?p <- advisor(?s, ?p), GraduateStudent(?s)",
    "?x, ?u <- memberOf(?x, ?dv), subOrganizationOf(?dv, ?u)",
    "?s, ?p, ?c <- advisor(?s, ?p), teacherOf(?p, ?c), takesCourse(?s, ?c)",
    '?s <- takesCourse(?s, "course2"), GraduateStudent(?s)',
    "?x <- knows(?x, ?x)",
    '<- Professor("prof1")',
    "?x, ?y <- GraduateStudent(?x), Course(?y)",  # cartesian
    "?p <- worksWith(?s, ?p), Faculty(?p)",
    '?q <- noSuchPred(?q)',
]
PAPER_QUERIES = [
    "?x, ?y <- S(?x, ?y)",
    '?x <- P(?x, "e2")',
    "?x, ?z <- P(?x, ?y), T(?y, ?z)",
    '<- S("a2", "d")',
    "?x <- R(?x), P(?x, ?y)",
]
CHAIN_QUERIES = [
    '?y <- path("v000002", ?y)',
    '?x <- path(?x, "v000030")',
    "?x, ?z <- edge(?x, ?y), path(?y, ?z)",
    "?x <- path(?x, ?x)",
]
STAR_QUERIES = [
    '?y <- S("s000004", ?y)',
    "?x, ?z <- S(?x, ?y), T(?y, ?z)",
    "?x <- P(?x, ?y), R(?x)",
]
#: ``benchmarks/bench_query.py``'s lubm queries
BENCH_LUBM_QUERIES = [
    '?s, ?c <- memberOf(?s, "dept3"), takesCourse(?s, ?c)',
    '?s, ?p, ?c <- advisor(?s, ?p), teacherOf(?p, ?c), takesCourse(?s, ?c)',
    '?s <- takesCourse(?s, "course7"), GraduateStudent(?s)',
    '?x, ?u <- memberOf(?x, ?dv), subOrganizationOf(?dv, ?u)',
]
#: ``(name, generator, kwargs, queries)``: ``tests/test_query.py``'s
#: ``TestDifferential`` KBs, and ``test_pallas_lookup_path``'s (its
#: two-constant queries are made from the KB's first ``takesCourse`` row)
TEST_QUERY_KBS = [
    ("lubm", "lubm_like", {"n_dept": 6, "n_students": 100, "n_courses": 12, "seed": 1},
     LUBM_QUERIES),
    ("paper", "paper_example", {"n": 6, "m": 4}, PAPER_QUERIES),
    ("chain", "chain", {"n": 40}, CHAIN_QUERIES),
    ("star", "star", {"n_spokes": 60, "n_hubs": 3}, STAR_QUERIES),
    ("lookup", "lubm_like", {"n_dept": 4, "n_students": 60, "n_courses": 8, "seed": 2}, []),
]
#: ``benchmarks/bench_query.py``'s non-smoke KBs and queries (its engines
#: run with ``dedup_index=True``)
BENCH_QUERY_KBS = [
    ("bench-lubm", "lubm_like", {"n_dept": 12, "n_students": 600, "n_courses": 40, "seed": 0},
     BENCH_LUBM_QUERIES),
    ("bench-chain", "chain", {"n": 150},
     ['?y <- path("v000003", ?y)', '?x, ?z <- edge(?x, ?y), path(?y, ?z)']),
    ("bench-paper", "paper_example", {"n": 32, "m": 12},
     ["?x, ?y <- S(?x, ?y)", '?x, ?z <- P(?x, ?y), T(?y, ?z)']),
]
#: a shared-plan micro-batch on the small lubm KBs: 32 queries of one
#: signature (``dept<k>`` past the KB's departments are unknown terms),
#: an ASK group and singles
SMALL_BATCH = ([f'?s, ?c <- memberOf(?s, "dept{k}"), takesCourse(?s, ?c)' for k in range(32)]
               + [f'<- memberOf("student{k}", "dept1")' for k in range(6)]
               + ["?s, ?p <- advisor(?s, ?p)",
                  '?c <- takesCourse("student1", ?c), teacherOf("prof1", ?c)'])
#: the full-size KB's query stream: ``bench_query.py``'s lubm queries and
#: one of two constant-bound atoms (the two-constant ASKs are added from
#: the oracle's rows)
FULL_QUERIES = BENCH_LUBM_QUERIES + [
    '?p <- advisor("student3", ?p), teacherOf(?p, "course2")',
]
#: the full-size 32-query batch: one signature whose generalised query
#: (the constant slot as a variable) joins ``teacherOf``'s 10,000 rows to
#: ``takesCourse``; ``SMALL_BATCH``'s template generalises to a cross-join
#: whose left side is all of ``memberOf`` (1,000,000 rows), which the
#: xjoin expands row by row on the host
BATCH_TEMPLATE = '?c, ?p <- takesCourse("student{k}", ?c), teacherOf(?p, ?c)'
FULL_BATCH = [BATCH_TEMPLATE.format(k=k) for k in range(32)]
#: timed repetitions of each full-size query, after one warm-up
QUERY_REPEATS = 5


def _exec_fields(stats) -> dict:
    """Every non-timing field of an ``ExecStats``."""
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)
            if f.name != "time_s"}


def _same_result(label, got, want) -> None:
    """A card result against the CPU one: answers, plan text, stats."""
    import torch

    if got.answers.device.type != "cuda":
        raise AssertionError(f"{label}: answers on {got.answers.device}, not the card")
    if not torch.equal(got.answers.cpu(), want.answers):
        raise AssertionError(f"{label}: answers differ (card vs CPU)")
    if got.plan.explain() != want.plan.explain():
        raise AssertionError(f"{label}: plans differ (card vs CPU)")
    if _exec_fields(got.stats) != _exec_fields(want.stats):
        raise AssertionError(f"{label}: ExecStats differ {_exec_fields(got.stats)} vs "
                             f"{_exec_fields(want.stats)}")
    if got.from_cache != want.from_cache:
        raise AssertionError(f"{label}: one result from the cache, the other not")


def _lookup_queries(flat, d) -> list[str]:
    """``test_pallas_lookup_path``'s queries: a true and a false ASK with
    two constants in one atom (from the first ``takesCourse`` row and a
    course its student does not take), and two constant-bound atoms."""
    import torch

    tc = flat["takesCourse"].cpu()
    s = int(tc[0, 0])
    taken = set(tc[tc[:, 0] == s, 1].tolist())
    other = next(c for c in torch.unique(tc[:, 1]).tolist() if c not in taken)
    return [f'<- takesCourse("{d.term_of(s)}", "{d.term_of(int(tc[0, 1]))}")',
            f'<- takesCourse("{d.term_of(s)}", "{d.term_of(other)}")',
            '?p <- advisor("student3", ?p), teacherOf(?p, "course2")']


def check_small_queries() -> None:
    """Phase 3: the same queries through ``QueryEngine`` over a card store
    and a CPU store (cold, then from the result cache), and
    ``SMALL_BATCH`` on the lubm KBs: everything equal."""
    from repro_torch.core import CMatEngine
    from repro_torch.core import generators
    from repro_torch.query import QueryEngine

    for name, gen, kw, queries in TEST_QUERY_KBS + BENCH_QUERY_KBS:
        program, dataset, d = getattr(generators, gen)(**kw)
        engines = {}
        for device in ("cuda", "cpu"):
            eng = CMatEngine(program, dedup_index=name.startswith("bench-"), device=device)
            eng.load(dataset)
            eng.materialise()
            engines[device] = QueryEngine(eng, d)
        card, cpu = engines["cuda"], engines["cpu"]
        if name == "lookup":
            queries = _lookup_queries(cpu.frozen.facts.to_dict(), d)
        for _ in range(2):  # cold, then from the result cache
            for text in queries:
                _same_result(f"small-query {name} {text!r}", card.answer(text), cpu.answer(text))
        n_batch = 0
        if gen == "lubm_like":
            for _ in range(2):
                got, got_stats = card.answer_batch(SMALL_BATCH)
                want, want_stats = cpu.answer_batch(SMALL_BATCH)
                if dataclasses.asdict(got_stats) != dataclasses.asdict(want_stats):
                    raise AssertionError(f"small-query {name}: BatchStats {got_stats} vs {want_stats}")
                for text, g, w in zip(SMALL_BATCH, got, want):
                    _same_result(f"small-query {name} batch {text!r}", g, w)
            n_batch = len(SMALL_BATCH)
        if card.cache_stats() != cpu.cache_stats():
            raise AssertionError(f"small-query {name}: cache counters differ")
        log(f"[small-query] {name}: {len(queries)} queries and {n_batch} batched equal "
            f"(card vs CPU), {card.cache_stats()}")


def _timed_answer(qe, text, reps: int) -> tuple:
    """``reps`` card walls of ``qe.answer(text)`` (host clock, ending in
    ``torch.cuda.synchronize()``) and the last result."""
    import torch

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = qe.answer(text)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls, res


def _fractions(res) -> dict:
    """``bench_query.py``'s evidence columns of one result."""
    scan = res.stats.unfold_fractions()
    join = res.stats.join_cell_fractions()
    return {
        "scan_frac": max(scan.values()) if scan else 0.0,
        "join_frac": max(join.values()) if join else 0.0,
        "full_unfolds": [p for p in res.stats.fully_unfolded()
                         if res.stats.pred_rows[p] > res.n_answers],
    }


def run_queries(eng, oracle, d) -> dict:
    """Phase 5: freeze the full-size card store and answer
    ``FULL_QUERIES``, the two-constant ASKs and ``FULL_BATCH`` on it, each
    answer equal to ``answer_flat`` over the CPU oracle; the launch meter
    covers exactly this stream."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.obs import get_registry
    from repro_torch.query import QueryEngine, answer_flat

    store = eng.store
    in_set_calls = get_registry().counter("kernels.in_set.calls")
    in_set_before = in_set_calls.value
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    qe = QueryEngine(eng, d, result_cache_size=0)
    frozen = qe.frozen
    frozen_nodes = (store.n_nodes(), store._next_id)
    queries = FULL_QUERIES + _lookup_queries(oracle, d)[:2]
    out = {"queries": [], "snapshot_build_s": {}}

    # each snapshot is built once, where the stream first needs it: time
    # that build (its unfolds and dedup) between two synchronisations
    plain_sorted_rows = frozen.sorted_rows

    def timed_sorted_rows(pred):
        if frozen.has_snapshot(pred):
            return plain_sorted_rows(pred)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = plain_sorted_rows(pred)
        torch.cuda.synchronize()
        out["snapshot_build_s"][pred] = time.perf_counter() - t0
        return rows

    frozen.sorted_rows = timed_sorted_rows
    for text in queries:
        walls, res = _timed_answer(qe, text, 1 + QUERY_REPEATS)  # warm-up first
        t0 = time.perf_counter()
        want = answer_flat(qe.parse(text), oracle)
        flat_s = time.perf_counter() - t0
        if not torch.equal(res.answers.cpu(), want):
            raise AssertionError(f"query {text!r}: answers differ from answer_flat")
        entry = {"query": text, "n_answers": res.n_answers, "card_first_s": walls[0],
                 "card_s": statistics.median(walls[1:]), "card_walls_s": walls[1:],
                 "flat_cpu_s": flat_s, **_fractions(res),
                 "stats": _exec_fields(res.stats)}
        out["queries"].append(entry)
        log(f"[query] {text}: {res.n_answers} answers, first "
            f"{qe.decode(res.answers[:3])}, equal to answer_flat")
        for line in res.plan.explain().splitlines():
            log(f"[query]   {line}")
        log(f"[query]   {entry}")
    if not (qe.answer(queries[-2]).ask and not qe.answer(queries[-1]).ask):
        raise AssertionError("query: the two-constant ASKs are not true, false")

    batch_qe = QueryEngine(frozen, d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, bstats = batch_qe.answer_batch(FULL_BATCH)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for text, res in zip(FULL_BATCH, results):
        if not torch.equal(res.answers.cpu(), answer_flat(batch_qe.parse(text), oracle)):
            raise AssertionError(f"batch {text!r}: answers differ from answer_flat")
    batch_flat_s = time.perf_counter() - t0
    out["batch"] = {"template": BATCH_TEMPLATE, "n": len(FULL_BATCH),
                    "stats": dataclasses.asdict(bstats), "card_s": batch_s,
                    "flat_cpu_s": batch_flat_s,
                    "n_answers": [r.n_answers for r in results]}
    log(f"[query] batch of {len(FULL_BATCH)} {BATCH_TEMPLATE!r}: {bstats}, card "
        f"{batch_s:.3f} s, flat on the CPU {batch_flat_s:.3f} s, answers "
        f"{out['batch']['n_answers']}, each equal to answer_flat")
    if bstats.n_groups != 1 or bstats.n_grouped != len(FULL_BATCH):
        raise AssertionError(f"batch: not answered as one generalised query: {bstats}")

    torch.cuda.synchronize()
    del frozen.sorted_rows
    out["launches"] = launch_counts()
    out["largest_launch"] = ops.largest_launches()
    out["one_key_m"] = max((s["m"] for s, _ in ops.launch_shapes("join_bounds")
                            if s.get("n") == 1), default=0)
    out["one_constant_n"] = max((s["n"] for s, _ in ops.launch_shapes("sorted_member")
                                 if s.get("m") == 1), default=0)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["in_set_calls"] = in_set_calls.value - in_set_before
    log(f"[query] launches {out['launches']}; in_set calls metered "
        f"(kernels.in_set.calls) {out['in_set_calls']}")
    log(f"[query] largest launch per kernel {out['largest_launch']}; widest n = 1 "
        f"join_bounds m {out['one_key_m']}, longest m = 1 sorted_member n "
        f"{out['one_constant_n']}")
    missing = [k for k in ("sorted_member", "join_bounds", "rle_expand")
               if out["launches"][k] == 0]
    if missing:
        raise AssertionError(f"query phase never launched: {missing}")
    if not out["one_key_m"] or not out["one_constant_n"] or not out["in_set_calls"]:
        raise AssertionError("query phase: no n = 1 join_bounds, m = 1 sorted_member "
                             "launch or metered in_set call")
    if (store.n_nodes(), store._next_id) != frozen_nodes:
        raise AssertionError(f"query: the store grew from {frozen_nodes} to "
                             f"{(store.n_nodes(), store._next_id)} nodes / next id")

    # the stream once more, as the sync count's run: the scratch must be
    # reclaimed again, and each planner count_eq is one host read
    count_eq = 0
    plain_count_eq = frozen.count_eq

    def counted(pred, pos, value):
        nonlocal count_eq
        count_eq += 1
        return plain_count_eq(pred, pos, value)

    frozen.count_eq = counted
    sync_qe = QueryEngine(frozen, d)

    def stream():
        for text in queries:
            sync_qe.answer(text)
        sync_qe.answer_batch(FULL_BATCH)

    _, out["syncs"] = _count_syncs(stream)
    del frozen.count_eq
    out["count_eq_calls"] = count_eq
    if (store.n_nodes(), store._next_id) != frozen_nodes:
        raise AssertionError("query: the repeated stream left scratch nodes behind")
    log(f"[query] host synchronisations in one pass of the stream (queries and "
        f"batch, snapshots built, plans cold): {out['syncs']}, of which count_eq "
        f"calls {count_eq}; store {frozen_nodes} nodes / next id before and after")

    out["snapshot_resident_bytes"] = frozen.snapshot_resident_bytes()
    out["snapshots"] = {p: int(frozen.snapshot(p).shape[0]) for p in sorted(frozen._sorted)}
    log(f"[query] snapshots {out['snapshots']} (rows), built in (s) "
        f"{out['snapshot_build_s']}, {sum(out['snapshot_build_s'].values()):.3f} s in all; "
        f"snapshot_resident_bytes {out['snapshot_resident_bytes']} (with the column "
        f"orders built since); max_memory_allocated in the phase "
        f"{out['max_memory_allocated']}")
    del qe, batch_qe, sync_qe, frozen
    return out


# --------------------------------------------------------------------- #
# phase 5a: provenance (and its checks in phases 2, 6, 10 and 13)
# --------------------------------------------------------------------- #
#: derived facts explained per small workload (phase 2), per full-size
#: run (phase 5a, drawn with seed 0) and per server run (phases 10, 13)
SMALL_EXPLAINS, FULL_EXPLAINS, SERVE_EXPLAINS = 50, 20, 8


@contextlib.contextmanager
def journal_on():
    """The port's derivation journal on, empty and at epoch 0; off and
    empty again after (the server's ``run`` leaves it as it found it only
    through ``main``)."""
    from repro_torch.obs.provenance import get_journal

    journal = get_journal()
    journal.enabled = True
    journal.clear()
    journal.begin_epoch(0)
    try:
        yield journal
    finally:
        journal.enabled = False
        journal.clear()
        journal.begin_epoch(0)


def _untimed_records(journal) -> list:
    """Every record slot but ``time_ns`` (host time)."""
    return [r.to_list()[:-1] for r in journal.records]


def _untimed_payload(payload: dict) -> dict:
    return {**payload,
            "records": [r[:-1] for r in payload["records"]],
            "costs": {rid: {k: v for k, v in c.items() if k != "time_ns"}
                      for rid, c in payload["costs"].items()}}


def _rule_costs(journal) -> dict:
    """The journal's whole cost table by ``rule_id``, host times aside."""
    return {h["rule_id"]: {k: v for k, v in h.items() if k != "time_ns"}
            for h in journal.hot_rules(len(journal.costs))}


def _derived_targets(mat: dict, explicit: dict, limit: int) -> list:
    """The first ``limit`` derived (not explicit) facts, in predicate and
    row order, from CPU copies."""
    out = []
    for pred in sorted(mat):
        rows = np.asarray(mat[pred].cpu()).reshape(mat[pred].shape[0], -1)
        exp = explicit.get(pred)
        seen = set() if exp is None else {
            tuple(map(int, r)) for r in np.asarray(exp.cpu()).reshape(-1, rows.shape[1])}
        for r in rows.tolist():
            if tuple(r) not in seen:
                out.append((pred, tuple(r)))
                if len(out) == limit:
                    return out
    return out


def _all_verified(node) -> bool:
    return node is not None and node["verified"] and all(
        _all_verified(c) for c in node["children"])


class _FactSet:
    """Membership of single facts in CPU row tables (arity <= 2), by a
    binary search over sorted packed codes."""

    def __init__(self, tables: dict):
        self.tables, self._codes = tables, {}

    @staticmethod
    def _code(terms) -> int:
        return terms[0] if len(terms) == 1 else (terms[0] << 32) | terms[1]

    def __contains__(self, fact) -> bool:
        import torch

        pred, terms = fact
        if pred not in self.tables:
            return False
        if pred not in self._codes:
            rows = torch.as_tensor(np.asarray(self.tables[pred])).cpu().to(torch.int64)
            rows = rows.reshape(rows.shape[0], -1)
            codes = rows[:, 0] if rows.shape[1] == 1 else (rows[:, 0] << 32) | rows[:, 1]
            self._codes[pred] = (torch.sort(codes).values, rows.shape[1])
        codes, arity = self._codes[pred]
        if arity != len(terms) or codes.shape[0] == 0:
            return False
        code = self._code(terms)
        i = int(torch.searchsorted(codes, torch.tensor([code])))
        return i < codes.shape[0] and int(codes[i]) == code


def _recheck_tree(node: dict, rules: list, oracle: _FactSet, explicit: _FactSet) -> int:
    """Re-check a proof tree on its own: every node's fact is in the flat
    oracle, every leaf is explicit, and each derived node's rule applied to
    exactly its children's facts yields that node.  Returns its nodes."""
    fact = (node["pred"], tuple(node["terms"]))
    if fact not in oracle:
        raise AssertionError(f"proof node {node['fact']} is not in the flat oracle")
    if node["kind"] == "explicit":
        if node["children"] or fact not in explicit:
            raise AssertionError(f"proof leaf {node['fact']} is not an explicit fact")
        return 1
    rule = rules[node["rule_id"]]
    children = node["children"]
    if len(children) != len(rule.body) or not children:
        raise AssertionError(f"{node['fact']}: {len(children)} children for {rule}")
    theta: dict = {}
    for atom, child in zip(rule.body, children):
        if child["pred"] != atom.predicate or len(child["terms"]) != len(atom.terms):
            raise AssertionError(f"{node['fact']}: child {child['fact']} against {atom}")
        for t, v in zip(atom.terms, child["terms"]):
            if (t != v) if isinstance(t, int) else (theta.setdefault(t, v) != v):
                raise AssertionError(f"{node['fact']}: {rule} does not match its children")
    head = tuple(t if isinstance(t, int) else theta[t] for t in rule.head.terms)
    if rule.head.predicate != node["pred"] or head != fact[1]:
        raise AssertionError(f"{node['fact']}: {rule} on its children yields {head}")
    return 1 + sum(_recheck_tree(c, rules, oracle, explicit) for c in children)


def _provenance_run(make, targets_of, explain) -> tuple:
    """One engine built with the journal on: ``(facts, untimed records,
    {target: proof tree})``."""
    with journal_on() as journal:
        eng, facts = make()
        records = _untimed_records(journal)
        trees = {t: explain(eng, *t) for t in targets_of(eng, facts)}
    return facts, records, trees


def check_small_provenance(name: str, program, dataset, plain: dict) -> None:
    """Phase 2 with the journal on: ``CMatEngine(fused=True)`` and
    ``FlatEngine`` on the card and on the CPU give the journal-off fact
    sets, equal records but for ``time_ns`` and equal, verified proof trees
    for up to ``SMALL_EXPLAINS`` derived facts."""
    from repro_torch.core import CMatEngine, FlatEngine

    def cmat(device):
        eng = CMatEngine(program, fused=True, device=device)
        eng.load(dataset)
        eng.materialise()
        return eng, eng.materialisation()

    def flat(device):
        eng = FlatEngine(program, device=device)
        eng.load(dataset)
        return eng, eng.materialise()

    targets = None
    for label, make, explicit_of in (("cmat", cmat, lambda e: e._explicit),
                                     ("flat", flat, lambda e: e._explicit)):
        runs = {}
        for device in ("cuda", "cpu"):
            runs[device] = _provenance_run(
                lambda: make(device),
                lambda eng, facts: targets or _derived_targets(facts, explicit_of(eng),
                                                               SMALL_EXPLAINS),
                lambda eng, pred, terms: eng.explain_fact(pred, terms))
            targets = targets or list(runs[device][2])
        (facts, records, trees), (cfacts, crecords, ctrees) = runs["cuda"], runs["cpu"]
        if not (_facts_equal(facts, plain) and _facts_equal(cfacts, plain)):
            raise AssertionError(f"small {name} {label}: the journal changed the fact set")
        if not records or records != crecords:
            raise AssertionError(f"small {name} {label}: journal records differ (card vs CPU)")
        if trees != ctrees or not all(_all_verified(t) for t in trees.values()):
            raise AssertionError(f"small {name} {label}: proof trees differ or are unverified")
        log(f"[small] {name} {label} with the journal: facts as without it, {len(records)} "
            f"records and {len(trees)} verified proof trees equal (card vs CPU)")


def run_provenance(program, dataset, full: dict, oracle: dict) -> dict:
    """Phase 5a: phase 4's load and materialise again with the journal on
    under a ``MemorySampler``, then ``explain_fact`` on the card for
    ``FULL_EXPLAINS`` derived facts drawn with seed 0, each tree re-checked
    against the CPU flat oracle on its own; the host syncs of a
    journal-off and a journal-on materialise."""
    import torch

    from repro_torch.core import CMatEngine
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_datalog import _sample_derived
    from repro_torch.obs import MemorySampler, metrics
    from repro_torch.obs.provenance import Explainer

    prev = metrics.set_registry(metrics.MetricsRegistry())
    try:
        with journal_on() as journal:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            with MemorySampler() as sampler:
                eng = CMatEngine(program, fused=True)
                eng.load(dataset)
                stats = eng.materialise()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            reg = metrics.get_registry()
            got = [stats.n_facts, stats.n_meta_facts, stats.rounds,
                   stats.rule_applications_skipped]
            want = [full[k] for k in ("n_facts", "n_meta_facts", "rounds",
                                      "rule_applications_skipped")]
            if got != want:
                raise AssertionError(f"provenance: stats {got} with the journal, {want} "
                                     "without")
            if not _facts_equal(eng.materialisation(), oracle):
                raise AssertionError("provenance: the journal changed the fact set")
            out = {
                "wall_s": wall,
                "records": len(journal.records),
                "dropped": journal.dropped,
                "journal_bytes": journal.memory_report()["journal_bytes"],
                "rule_gauges": reg.snapshot("rule."),
                "mem_peak": reg.snapshot("mem.peak.materialise."),
                "sampler": {"samples": sampler.samples, "throttled": sampler.throttled,
                            "time_s": sampler.time_ns / 1e9},
                "hot_rules": journal.hot_rules(5),
            }
            targets = _sample_derived(eng.materialisation(), eng._explicit, FULL_EXPLAINS, 0)
            if len(targets) != FULL_EXPLAINS:
                raise AssertionError(f"provenance: {len(targets)} derived facts drawn")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._prov_tables = Explainer.build_tables(eng.facts)
            torch.cuda.synchronize()
            out["table_build_s"] = time.perf_counter() - t0
            walls, trees = [], []
            for pred, terms in targets:
                t0 = time.perf_counter()
                node = eng.explain_fact(pred, terms)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if not _all_verified(node):
                    raise AssertionError(f"provenance: {pred}{terms} not found or unverified")
                trees.append(node)
            launches = launch_counts()
        for k in ("rle_expand", "sorted_member"):
            if not launches[k]:
                raise AssertionError(f"provenance: {k} never launched")
        t0 = time.perf_counter()
        facts, explicit = _FactSet(oracle), _FactSet(dataset)
        nodes = [_recheck_tree(t, list(program), facts, explicit) for t in trees]
        out.update({
            "explained": len(trees),
            "verified": len(trees),
            "proof_nodes": nodes,
            "proof_depths": [_depth(t) for t in trees],
            "recheck_s": time.perf_counter() - t0,
            "explain_median_s": statistics.median(walls),
            "explain_max_s": max(walls),
            "launches": launches,
        })
    finally:
        metrics.set_registry(prev)
    del eng

    def materialise():
        e = CMatEngine(program, fused=True)
        e.load(dataset)
        e.materialise()

    _, out["syncs_journal_off"] = _count_syncs(materialise)
    with journal_on():
        _, out["syncs_journal_on"] = _count_syncs(materialise)
    log(f"[provenance] lubm_like({N_DEPT}, {N_STUDENTS}, {N_COURSES}) with the journal and "
        f"a MemorySampler: {out}")
    log(f"[provenance] {len(trees)}/{FULL_EXPLAINS} sampled explanations verified on the "
        f"card and re-checked against the flat oracle; table build "
        f"{out['table_build_s']:.3f} s, explain median {out['explain_median_s']:.4f} s, max "
        f"{out['explain_max_s']:.4f} s; syncs journal off {out['syncs_journal_off']}, on "
        f"{out['syncs_journal_on']}")
    return out


def _depth(node: dict) -> int:
    return 1 + max((_depth(c) for c in node["children"]), default=0)


# --------------------------------------------------------------------- #
# phases 6-8: the distributed engine and the closure
# --------------------------------------------------------------------- #
def _nonempty(facts: dict) -> dict:
    return {p: r for p, r in facts.items() if r.shape[0]}


def _dist_stats(stats) -> dict:
    """Every non-timing field of a ``DistributedStats``."""
    return {
        f.name: getattr(stats, f.name)
        for f in dataclasses.fields(stats)
        if not f.name.startswith("time_")
    }


#: phase 6's shard counts; at 4 all shards sit on the one card
SMALL_DIST_SHARDS = (1, 4)
#: the exchange-bucket regrow at 4 shards: ``bipartite(100, 1)`` re-keys
#: A(x_i, hub) on the hub, ~25 rows a shard into buckets of 64 // 4 slots,
#: while no join outgrows its padding of 1,024
HUB_KW = {"capacity": 64, "join_capacity": 1024}


def check_small_distributed() -> None:
    """The engine on the card against the same engine on the CPU, at 1 and
    4 shards: fact sets, stats and every shard's state buffers row for
    row; with the journal on, the records after ``merge_shard_records``."""
    import torch

    from repro_torch.core.distributed import DistributedEngine
    from repro_torch.core.generators import bipartite, chain, lubm_like, paper_example

    workloads = [
        ("chain", lambda: chain(15), {}),
        ("paper", lambda: paper_example(4, 3), {}),
        ("lubm", lambda: lubm_like(4, 50, 8), {}),
        ("chain-regrow", lambda: chain(30), {"join_capacity": 8}),
        ("hub-regrow", lambda: bipartite(100, 1), HUB_KW),
    ]
    for n_shards in SMALL_DIST_SHARDS:
        for name, gen, kw in workloads:
            if name == "hub-regrow" and n_shards == 1:
                continue  # its 100 spokes fit 64 slots only when spread
            program, dataset, _ = gen()
            program = DistributedEngine.supported_program(program)
            kw = {"capacity": 1 << 10, **kw, "n_shards": n_shards}
            label = f"{name} at {n_shards} shard(s)"
            runs = {}
            for device in ("cuda", "cpu"):
                eng = DistributedEngine(program, device=device, **kw)
                eng.materialise(dataset)
                runs[device] = eng
            card, cpu = runs["cuda"], runs["cpu"]
            if not _facts_equal(card.to_dict(), cpu.to_dict()):
                raise AssertionError(f"small-distributed {label}: fact sets differ (card vs CPU)")
            if _dist_stats(card.stats) != _dist_stats(cpu.stats):
                raise AssertionError(f"small-distributed {label}: stats differ (card vs CPU)")
            for p, (rows, cnt, lo) in cpu._state.items():
                crows, ccnt, clo = card._state[p]
                if (ccnt, clo) != (cnt, lo) or len(crows) != n_shards or not all(
                    torch.equal(c.cpu(), r) for c, r in zip(crows, rows)
                ):
                    raise AssertionError(f"small-distributed {label}: state of {p} differs")
            st = card.stats
            if name == "chain-regrow" and not st.exchange_regrows:
                raise AssertionError(f"small-distributed {label}: the join padding never regrew")
            if name == "hub-regrow" and not (
                st.exchange_regrows
                and max(r["rows_joined"] for r in st.per_round) <= kw["join_capacity"]
            ):
                raise AssertionError(f"small-distributed {label}: no exchange bucket regrew")
            if n_shards > 1 and not st.exchanges:
                raise AssertionError(f"small-distributed {label}: no exchange")
            log(f"[small-distributed] {label}: equal, rounds {st.rounds}, rows_joined "
                f"{st.rows_joined}, exchanges {st.exchanges} ({st.exchanges_skipped} "
                f"elided), exchange_regrows {st.exchange_regrows}")
            # with the journal on: the records after ``merge_shard_records``
            # (``check_integrity``) equal card vs CPU
            records = {}
            for device in ("cuda", "cpu"):
                with journal_on() as journal:
                    eng = DistributedEngine(program, device=device, **kw)
                    eng.materialise(dataset)
                    eng.check_integrity(cpu.to_dict())
                    records[device] = _untimed_records(journal)
            if not records["cuda"] or records["cuda"] != records["cpu"]:
                raise AssertionError(f"small-distributed {label}: journal records differ")
            log(f"[small-distributed] {label}: {len(records['cuda'])} merged journal "
                "records equal (card vs CPU)")


def _drop_rows(rows: np.ndarray, drop: np.ndarray) -> np.ndarray:
    """``rows`` without those in ``drop`` (binary rows of 15-bit ids)."""
    def code(r):
        return r[:, 0].astype(np.int64) << 32 | r[:, 1].astype(np.int64)

    return rows[~np.isin(code(rows), code(drop))]


def run_full_distributed(n_shards: int = 1, oracles: dict | None = None,
                         devices: list | None = None) -> dict:
    """Phase 7 at ``n_shards`` shards, all on the card or one on each of
    ``devices``: materialise (stats against the reference's, facts against
    the flat oracle), then a 1 % delete ``apply`` and its re-add, each
    against the flat oracle of the edited explicit set.  ``oracles`` are
    those of an earlier call, which are computed (on the CPU) when it is
    None."""
    import torch

    from repro_torch.core.distributed import DistributedEngine
    from repro_torch.core.flat import flat_seminaive
    from repro_torch.core.generators import lubm_like
    from repro_torch.kernels import ops

    tag = f"[full-distributed {n_shards}{'' if devices is None else ' cards'}]"
    where = "on the card" if devices is None else f"on {[str(d) for d in devices]}"
    expected = DIST_EXPECTED if n_shards == 1 else DIST_EXPECTED_4
    program, dataset, _ = lubm_like(**DIST_KB)
    program = DistributedEngine.supported_program(program)
    n_explicit = sum(int(v.shape[0]) for v in dataset.values())
    log(f"{tag} lubm_like({DIST_KB}): {n_explicit} explicit triples, "
        f"{len(program)} rules, {n_shards} shard(s) {where}, capacity = "
        f"join_capacity = {DIST_CAPACITY} a shard")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng = DistributedEngine(program, capacity=DIST_CAPACITY, join_capacity=DIST_CAPACITY,
                            n_shards=n_shards, devices=devices)
    facts = eng.materialise(dataset)  # every predicate, the empty ones too
    for d in eng.devices:
        torch.cuda.synchronize(d)
    t_mat = time.perf_counter() - t0
    launches = launch_counts()
    largest = ops.largest_launches()
    log(f"{tag} largest launch per kernel {largest}")
    n_facts = sum(int(r.shape[0]) for r in facts.values())
    got = {k: getattr(eng.stats, k) for k in expected}
    log(f"{tag} materialise {t_mat:.3f} s, {got}, {n_facts} facts over "
        f"{len(facts)} predicates, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()}")
    log(f"{tag} launches {launches}")
    if got != expected or (n_facts, len(facts)) != (DIST_FACTS, DIST_PREDICATES):
        raise AssertionError(
            f"full-distributed at {n_shards} shard(s): stats {got}, {n_facts} facts "
            f"over {len(facts)} predicates; the reference gives {expected}, "
            f"{DIST_FACTS} over {DIST_PREDICATES}"
        )
    missing = [k for k in ("sorted_member", "join_bounds") if launches[k] == 0]
    if missing:
        raise AssertionError(f"full-distributed at {n_shards} shard(s) never launched: {missing}")
    if oracles is None:
        t0 = time.perf_counter()
        rng = np.random.default_rng(0)
        dels = {
            p: dataset[p][rng.choice(dataset[p].shape[0], dataset[p].shape[0] // 100,
                                     replace=False)]
            for p in ("takesCourse", "advisor")
        }
        edited = {p: _drop_rows(r, dels[p]) if p in dels else r for p, r in dataset.items()}
        oracles = {"dels": dels,
                   "full": _nonempty(flat_seminaive(program, dataset, device="cpu")),
                   "edited": _nonempty(flat_seminaive(program, edited, device="cpu"))}
        log(f"{tag} flat oracles on the CPU: {time.perf_counter() - t0:.1f} s")
    if not _facts_equal(_nonempty(facts), oracles["full"]):
        raise AssertionError(f"full-distributed at {n_shards} shard(s): fact set differs "
                             "from flat_seminaive")
    log(f"{tag} fact set equals flat_seminaive")

    dels = oracles["dels"]
    apply_launches = dict.fromkeys(launches, 0)
    apply_largest = {k: {} for k in launches}
    apply_s = {}
    for label, batch, want in (
        ("delete", {"deletions": dels}, oracles["edited"]),
        ("re-add", {"additions": dels}, oracles["full"]),
    ):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        st = eng.apply(**batch)
        for d in eng.devices:
            torch.cuda.synchronize(d)
        apply_s[label] = t_apply = time.perf_counter() - t0
        for k, v in launch_counts().items():
            apply_launches[k] += v
        for k, v in ops.largest_launches().items():
            if sum(v.values()) > sum(apply_largest[k].values()):
                apply_largest[k] = v
        log(f"{tag} apply {label} of "
            f"{sum(int(r.shape[0]) for r in dels.values())} rows: {t_apply:.3f} s, "
            f"rounds {st.rounds}, rule applications {st.n_rule_applications}, "
            f"overdeleted {st.n_overdeleted}, rederived {st.n_rederived}, deleted "
            f"{st.n_deleted}, inserted {st.n_inserted}, exchanges {st.exchanges} "
            f"({st.exchanges_skipped} elided), exchange_regrows {st.exchange_regrows}")
        if not _facts_equal(eng.to_dict(), want):
            raise AssertionError(f"full-distributed at {n_shards} shard(s) apply {label}: "
                                 "differs from re-materialisation")
        log(f"{tag} apply {label}: equals flat_seminaive of the edited explicit set")
    log(f"{tag} apply launches {apply_launches}")
    log(f"{tag} apply largest launch per kernel {apply_largest}")
    return {"engine": eng, "launches": launches, "apply_launches": apply_launches,
            "largest": largest, "apply_largest": apply_largest, "materialise_s": t_mat,
            "apply_s": apply_s, "oracles": oracles}


def run_examples() -> dict:
    """Phase 7a: ``repro_torch.examples.quickstart`` and
    ``distributed_reasoning`` on the card, each checking itself against the
    flat oracle; their rounds."""
    import io

    from repro_torch.examples import distributed_reasoning, quickstart

    out = {}
    for name, run in (("quickstart", lambda: quickstart.main([])["rounds"]),
                      ("distributed_reasoning", lambda: distributed_reasoning.main([]).rounds)):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rounds = run()
        wall = time.perf_counter() - t0
        last = buf.getvalue().strip().splitlines()[-1]
        log(f"[examples] {name}: {rounds} rounds, {wall:.3f} s; {last!r}")
        out[name] = {"rounds": rounds, "wall_s": wall}
    return out


def run_closure(eng) -> dict:
    """Apply each two-atom rule whose head is (left-only variable,
    right-only variable) once more through ``fused_join_dedup`` and fold
    the output into an int32 ``FactBuffers`` seeded with the head
    relation: the store is closed, so nothing may be new.  Each rule's
    inputs must equal those the flat oracle gives (:func:`_closure_case`
    rebuilds the timed cases from it); every launch is recorded."""
    import torch

    from repro_torch.core.distributed import pack_pairs
    from repro_torch.kernels import fused_join_dedup, ops, ref
    from repro_torch.kernels.buffers import FactBuffers

    facts = eng.to_dict()
    dev = eng.device
    oracle = {rule.head.predicate: args
              for rule, args in closure_joins(*_kb_facts(tuple(sorted(DIST_KB.items()))), dev)}

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    buffers = FactBuffers(dev, dtype=torch.int32)
    joins = []
    for rule, args in closure_joins(eng.program, facts, dev):
        head = rule.head.predicate
        if not all(torch.equal(x, y) for x, y in zip(args, oracle[head])):
            raise AssertionError(f"closure {rule}: inputs differ from the flat oracle's")
        capacity = CLOSURE_FIRST_CAPACITY
        while True:
            out, count, total = fused_join_dedup(*args, capacity)
            p_out, p_count, p_total = ref.fused_join_dedup(*args, capacity)
            torch.cuda.synchronize()
            if total != p_total or not (torch.equal(out, p_out) and torch.equal(count, p_count)):
                raise AssertionError(f"closure {rule}: kernel != plain version at capacity {capacity}")
            joins.append({"kb": DIST_KB, "head": head, "n": args[0].shape[0],
                          "m": args[2].shape[0], "capacity": capacity,
                          "pairs": min(total, capacity)})
            if total <= capacity:
                break
            capacity = 1 << (total - 1).bit_length()  # regrow and call again
        buffers.merge(head, torch.sort(pack_pairs(_rows(facts, rule.head, dev))).values)
        n_new = buffers.merge(head, out)
        log(f"[closure] {rule}: {args[0].shape[0]} x {args[2].shape[0]} rows, "
            f"{total} pairs, {int(count[0])} unique at capacity {capacity}, "
            f"n_new {n_new}")
        if n_new:
            raise AssertionError(f"closure {rule}: {n_new} new facts in a closed store")
    launches = launch_counts()
    shapes = ops.launch_shapes("fused_join_dedup")
    log(f"[closure] {len(oracle)} rules, launches {launches}, largest "
        f"{ops.largest_launches()['fused_join_dedup']}")
    log(f"[closure] fused_join_dedup launch shapes (launch meter): {shapes}")
    if not joins or not launches["fused_join_dedup"] or not launches["merge_sorted_unique"]:
        raise AssertionError("closure: fused_join_dedup or the int32 merge never launched")
    metered = sorted(tuple(sorted(shape.items())) for shape, c in shapes for _ in range(c))
    recorded = sorted(tuple(sorted((k, v) for k, v in j.items() if k not in ("kb", "head")))
                      for j in joins)
    if metered != recorded:
        raise AssertionError(f"closure: metered launches {metered}, recorded {recorded}")
    return {"launches": launches, "largest_launch": ops.largest_launches(), "joins": joins}


# --------------------------------------------------------------------- #
# phases 10-12: the server (launch/serve_datalog.py)
# --------------------------------------------------------------------- #
#: the server's full-size KB, ``--kb lubm --scale 10000``:
#: ``lubm_like(40_000, 1_000_000, 80_000)``
SERVE_SCALE = 10_000
SERVE_QUERIES = 1000
#: the live phase's stream: a batch every ``LIVE_EVERY`` queries
LIVE_QUERIES, LIVE_EVERY, LIVE_SIZE = 250, 50, 8
#: phase 12's own stream: 2 batches (cut from ``LIVE_QUERIES``' 4 to keep the
#: smoke within 80 % of its time limit; phase 13 still applies 4 there)
LIVE_PHASE_QUERIES, LIVE_PHASE_BATCHES = 150, 2
#: the provenance flags of the server runs that explain (phases 10, 13)
PROVENANCE_FLAGS = ["--provenance", "--hot-rules", "--explain-sample", "8"]
#: the small phase: the server's static and live runs at ``--scale 1``,
#: explaining a derived fact of that KB and a sample
SMALL_SERVE = [
    ["--kb", "lubm", "--scale", "1", "--n-queries", "300", *PROVENANCE_FLAGS,
     "--explain", "Agent(prof6)"],
    ["--kb", "lubm", "--scale", "1", "--n-queries", "300", "--live", "--update-every",
     "100", "--update-size", "6", "--live-verify", *PROVENANCE_FLAGS,
     "--explain", "Agent(prof6)"],
]
#: report keys that hold times, or the lengths of the journal's time floats
SERVE_TIMED = ("seconds", "qps", "time", "apply_s", "journal_bytes")


def _read_report(path: Path) -> dict[str, dict]:
    blocks = {}
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        blocks[rec.pop("block")] = rec
    return blocks


def _serve(argv: list[str]):
    """One in-process run of the port's server with a fresh metrics
    registry: ``(ServeRun, report blocks by tag)``."""

    from repro_torch.launch import serve_datalog as serve
    from repro_torch.obs import metrics

    prev = metrics.set_registry(metrics.MetricsRegistry())
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "report.jsonl"
            served = serve.run([*argv, "--report-json", str(path)])
            blocks = _read_report(path)
    finally:
        metrics.set_registry(prev)
    if served.rc:
        raise AssertionError(f"serve {' '.join(argv)}: exit code {served.rc}")
    return served, blocks


def _untimed(block: dict) -> dict:
    return {k: v for k, v in block.items() if not any(t in k for t in SERVE_TIMED)}


def _serve_explaining(argv: list[str]):
    """``_serve`` with the journal on: ``(ServeRun, blocks, the journal's
    cost table by rule_id)``."""
    with journal_on() as journal:
        served, blocks = _serve(argv)
        return served, blocks, _rule_costs(journal)


def _check_provenance_block(label: str, card: dict, cpu: dict, costs: dict,
                            cpu_costs: dict) -> None:
    """The ``[provenance]`` blocks of two runs: every field but
    ``hot_rules`` equal; ``hot_rules`` (ranked by host time) by
    ``rule_id`` against the two equal cost tables; every explanation
    found and verified."""
    if costs != cpu_costs:
        raise AssertionError(f"{label}: rule cost tables differ")
    a, b = dict(card), dict(cpu)
    hot = a.pop("hot_rules") + b.pop("hot_rules")
    if a != b:
        raise AssertionError(f"{label}: [provenance] {a} != {b}")
    if any({k: v for k, v in h.items() if k != "time_ns"} != costs[h["rule_id"]]
           for h in hot):
        raise AssertionError(f"{label}: hot_rules disagree with the cost table")
    if not a["explanations"] or not all(e["verified"] for e in a["explanations"]):
        raise AssertionError(f"{label}: explanations {a['explanations']}")


def check_small_serve() -> None:
    """Phase 10: the server at ``--scale 1`` on the card and on the CPU,
    static and ``--live --live-verify``, both with the provenance flags:
    every non-timing report field equal, ``hot_rules`` by ``rule_id``."""
    for argv in SMALL_SERVE:
        (_, card, costs), (_, cpu, cpu_costs) = (
            _serve_explaining([*argv, "--device", d]) for d in ("cuda", "cpu"))
        if set(card) != set(cpu):
            raise AssertionError(f"serve-small {argv}: blocks {set(card) ^ set(cpu)} differ")
        _check_provenance_block(f"serve-small {argv}", card["provenance"], cpu["provenance"],
                                costs, cpu_costs)
        for block in sorted(set(card) - {"latency", "memory", "kernels", "provenance"}):
            if _untimed(card[block]) != _untimed(cpu[block]):
                raise AssertionError(f"serve-small {argv}: [{block}] {card[block]} != {cpu[block]}")
        if not any(card["kernels"]["launches"].values()):
            raise AssertionError(f"serve-small {argv}: no kernel launched on the card")
        if "--live" in argv and not card["live-verify"]["ok"]:
            raise AssertionError(f"serve-small {argv}: live-verify failed")
        log(f"[serve-small] {' '.join(argv)}: card and CPU reports equal "
            f"({len(card) - 3} blocks compared), answers {card['serve']['answers']}, "
            f"card launches {card['kernels']['launches']}; [provenance] "
            f"{card['provenance']['records']} records, "
            f"{len(card['provenance']['explanations'])} explanations verified")


def _percentiles(walls_s) -> dict:
    ms = np.asarray(walls_s) * 1e3
    return {f"p{q}_ms": float(np.percentile(ms, q)) for q in (50, 90, 99)}


def _check_launched(phase: str, launches: dict) -> None:
    missing = [k for k in ("sorted_member", "join_bounds", "rle_expand") if launches[k] == 0]
    if missing:
        raise AssertionError(f"{phase}: never launched {missing}")


def run_serve(oracle) -> dict:
    """Phase 11: the static server at ``--scale 10000`` on the card; its
    fact count and answer total held against the flat oracle."""
    import collections

    import torch

    from repro_torch.kernels import ops
    from repro_torch.query import QueryEngine, answer_flat

    argv = ["--kb", "lubm", "--scale", str(SERVE_SCALE), "--n-queries", str(SERVE_QUERIES)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    served, blocks = _serve(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, largest = launch_counts(), ops.largest_launches()
    n_oracle = sum(int(r.shape[0]) for r in oracle.values())
    if blocks["materialise"]["n_facts"] != n_oracle:
        raise AssertionError(f"serve: {blocks['materialise']['n_facts']} facts, the flat "
                             f"oracle {n_oracle}")
    want = 0
    t1 = time.perf_counter()
    for text, count in collections.Counter(served.stream).items():
        want += count * int(answer_flat(served.qe.parse(text), oracle).shape[0])
    flat_s = time.perf_counter() - t1
    if blocks["serve"]["answers"] != want:
        raise AssertionError(f"serve: {blocks['serve']['answers']} answers, answer_flat {want}")
    _check_launched("serve", launches)
    out = {
        "wall_s": wall,
        "materialise_s": blocks["materialise"]["seconds"],
        "n_facts": n_oracle,
        "n_meta_facts": blocks["materialise"]["n_meta_facts"],
        "serve_s": blocks["serve"]["seconds"],
        "qps": blocks["serve"]["qps"],
        **_percentiles(served.latencies_s),
        "hit_rate": blocks["cache"]["hit_rate"],
        "mu_nodes": blocks["store"]["mu_nodes"],
        "answers": want,
        "answer_flat_s": flat_s,
        "kernels_meter": {k: v for k, v in blocks["kernels"].items() if k != "launches"},
        "launches": launches,
        "largest_launch": largest,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
    # one more pass of the stream over the same snapshots, plans and
    # results cold, as the sync count's run
    qe = QueryEngine(served.qe.frozen, served.dictionary)
    _, out["syncs"] = _count_syncs(lambda: [qe.answer(t) for t in served.stream])
    log(f"[serve] {' '.join(argv)}: {out}")
    log(f"[serve] fact count and answer total ({want}) equal the flat oracle's; "
        f"host syncs of one pass of the stream {out['syncs']}")
    del served, qe
    return out


def run_live(oracle_facts: int, profile: bool) -> dict:
    """Phase 12: the live server at ``--scale 10000`` on the card, ending
    ``[live-verify] OK``; then one more batch with the syncs counted, and
    with ``profile`` one more batch and the queries up to the next one
    under ``torch.profiler``."""
    import torch

    from repro_torch.kernels import ops

    argv = ["--kb", "lubm", "--scale", str(SERVE_SCALE), "--n-queries", str(LIVE_PHASE_QUERIES),
            "--live", "--update-every", str(LIVE_EVERY), "--update-size", str(LIVE_SIZE),
            "--live-verify"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    served, blocks = _serve(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, largest = launch_counts(), ops.largest_launches()
    live = blocks["live"]
    if not blocks["live-verify"]["ok"]:
        raise AssertionError("live: live-verify failed")
    if live["inc.epoch"] != served.applied or served.applied < LIVE_PHASE_BATCHES:
        raise AssertionError(f"live: epoch {live['inc.epoch']} after {served.applied} batches")
    if blocks["materialise"]["n_facts"] != oracle_facts:
        raise AssertionError(f"live: {blocks['materialise']['n_facts']} facts loaded, the "
                             f"flat oracle {oracle_facts}")
    _check_launched("live", launches)
    out = {
        "wall_s": wall,
        "load_s": blocks["materialise"]["seconds"],
        "batches": served.applied,
        "epoch": live["inc.epoch"],
        **{f"apply_{k}": v for k, v in _percentiles(served.apply_s).items()},
        "apply_s": served.apply_s,
        "inc": {k: v for k, v in live.items() if k.startswith("inc.n_") or k in (
            "inc.counting_strata", "inc.dred_strata", "inc.batches", "stale_evictions")},
        "queries": blocks["serve"]["queries"],
        "qps": blocks["serve"]["qps"],
        **_percentiles(served.latencies_s),
        "verified_facts": blocks["live-verify"]["facts"],
        "mu_gc": {k: v for k, v in blocks["mu-gc"].items() if "time" not in k},
        "launches": launches,
        "largest_launch": largest,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
    inc = served.inc
    dels, adds = served.batches[served.applied]
    _, out["syncs_one_batch"] = _count_syncs(
        lambda: inc.apply(additions=adds, deletions=dels))
    log(f"[live] {' '.join(argv)}: {out}")
    log(f"[live] [live-verify] OK at epoch {out['epoch']} after {served.applied} batches; "
        f"host syncs of one more batch {out['syncs_one_batch']}")
    if profile:
        dels, adds = served.batches[served.applied + 1]
        qe, texts = served.qe, served.stream[:LIVE_EVERY]

        def batch_and_queries():
            inc.apply(additions=adds, deletions=dels)
            inc.maybe_compact()
            qe.bump_epoch(inc)
            for text in texts:
                qe.answer(text)

        _profile_call("live batch + queries", batch_and_queries)
    del served, inc
    return out


# --------------------------------------------------------------------- #
# phases 13-15: the durable, concurrent and distributed server
# --------------------------------------------------------------------- #
#: the durable phase checkpoints every ``DURABLE_EVERY`` batches and is cut
#: short before its final checkpoint, so one batch is left in the WAL
DURABLE_EVERY = 3
#: the restore run's stream: no batch, the queries after a warm start
DURABLE_RESTORE_QUERIES = 10
#: the mvcc phase: its clients, queries, a batch every ``MVCC_UPDATE_EVERY``
#: queries (one batch; cut from 100 queries with a batch every 50, then
#: from 50 with a batch every 25, to keep the smoke within its time limit)
#: and the checkpoint interval
MVCC_CLIENTS, MVCC_QUERIES, MVCC_UPDATE_EVERY, MVCC_EVERY = 4, 25, 13, 2
#: the distributed phase's KB: the largest ``--scale`` whose ids stay
#: below the engine's 2**15 limit (the generator's largest id is 120 *
#: scale, 32,400 here)
DIST_SERVE_SCALE = 270
#: the small cross-device check of snapshots, at ``--scale 1``
SMALL_DURABLE = ["--kb", "lubm", "--scale", "1", "--n-queries", "300", "--live",
                 "--update-every", "100", "--update-size", "6", "--checkpoint-every", "2"]


class _Crash(Exception):
    """Raised in place of the final checkpoint: the server stops as a
    crash would stop it, after its last batch was logged and applied."""

    def __init__(self, inc):
        super().__init__(f"crash before the checkpoint of epoch {inc.epoch}")
        self.inc = inc


def _live_argv(scale: int, n_queries: int, every: int = LIVE_EVERY) -> list[str]:
    return ["--kb", "lubm", "--scale", str(scale), "--n-queries", str(n_queries), "--live",
            "--update-every", str(every), "--update-size", str(LIVE_SIZE), "--live-verify"]


def check_small_durable(tmp: Path) -> dict:
    """The server's snapshot at ``--scale 1`` written from the card and
    from the CPU: equal ``data.bin`` SHA-256, and each restores on the
    other device to the same ``to_dict``."""
    import hashlib

    import torch

    from repro_torch.launch.serve_datalog import build_kb
    from repro_torch.storage import CheckpointManager

    runs, digests, sidecars = {}, {}, {}
    for dev in ("cuda", "cpu"):
        root = tmp / f"small-{dev}"
        served, _, _ = _serve_explaining(
            [*SMALL_DURABLE, *PROVENANCE_FLAGS, "--checkpoint-dir", str(root), "--device", dev])
        runs[dev] = {p: r.cpu() for p, r in served.inc.to_dict().items()}
        snap = Path(served.ckpt.latest())
        digests[dev] = hashlib.sha256((snap / "data.bin").read_bytes()).hexdigest()
        sidecars[dev] = json.loads((snap / "provenance.json").read_text())
    if digests["cuda"] != digests["cpu"]:
        raise AssertionError(f"durable-small: data.bin differs by device {digests}")
    if _untimed_payload(sidecars["cuda"]) != _untimed_payload(sidecars["cpu"]):
        raise AssertionError("durable-small: provenance.json differs by device (time_ns aside)")
    program, _, _ = build_kb("lubm", 1)
    targets = None
    for written, restored_on in (("cuda", "cpu"), ("cpu", "cuda")):
        mgr = CheckpointManager(str(tmp / f"small-{written}"), label="lubm:scale1")
        with journal_on() as journal:
            inc, _ = mgr.restore(program, device=restored_on)
            if journal.to_payload() != sidecars[written]:
                raise AssertionError(f"durable-small: the {written} sidecar was not loaded "
                                     f"on {restored_on}")
            targets = targets or _derived_targets(inc.to_dict(), inc.explicit, SERVE_EXPLAINS)
            if not all(_all_verified(inc.explain_fact(p, t)) for p, t in targets):
                raise AssertionError(f"durable-small: an explanation after the restore on "
                                     f"{restored_on} is not verified")
        got = {p: r.cpu() for p, r in inc.to_dict().items()}
        if set(got) != set(runs[written]) or not all(
                torch.equal(got[p], runs[written][p]) for p in got):
            raise AssertionError(f"durable-small: a {written} snapshot restored on "
                                 f"{restored_on} differs")
    log(f"[durable-small] --scale 1 snapshot from the card and from the CPU: data.bin "
        f"SHA-256 {digests['cuda']} in both; provenance.json equal but for time_ns "
        f"({len(sidecars['cuda']['records'])} records); each restores on the other device "
        f"to the same to_dict, loads the other's sidecar and explains "
        f"{len(targets)} facts, verified")
    return {"data_sha256": digests["cuda"]}


def run_durable(tmp: Path, oracle_facts: int) -> dict:
    """Phase 13: the live server at ``--scale 10000`` with a checkpoint
    every ``DURABLE_EVERY`` batches, stopped by a simulated crash in place
    of its final checkpoint (snapshot at epoch 3, batch 4 in the WAL);
    then the same server in process with ``--restore``: a warm start from
    epoch 3 replaying one batch to epoch 4, equal to the crashed store,
    ``[live-verify] OK``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve_datalog as serve
    from repro_torch.obs import metrics
    from repro_torch.storage import CheckpointManager, snapshot_nbytes

    out = check_small_durable(tmp)
    root = tmp / "durable"
    argv = [*_live_argv(SERVE_SCALE, LIVE_QUERIES), *PROVENANCE_FLAGS, "--checkpoint-dir",
            str(root), "--checkpoint-every", str(DURABLE_EVERY)]
    real = CheckpointManager.checkpoint
    walls: list[tuple[int, float]] = []

    def checkpoint(self, inc):
        if inc.epoch % DURABLE_EVERY:
            raise _Crash(inc)
        t0 = time.perf_counter()
        manifest = real(self, inc)
        walls.append((inc.epoch, time.perf_counter() - t0))
        return manifest

    prev = metrics.set_registry(metrics.MetricsRegistry())
    CheckpointManager.checkpoint = checkpoint
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    report = tmp / "durable.jsonl"
    t0 = time.perf_counter()
    crashed_records = []
    try:
        with journal_on() as journal:
            try:
                serve.run([*argv, "--report-json", str(report)])
            finally:
                crashed_records.append(len(journal.records))
        raise AssertionError("durable: the server reached its final checkpoint")
    except _Crash as crash:
        crashed = crash.inc
    finally:
        CheckpointManager.checkpoint = real
        metrics.set_registry(prev)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    cold = _read_report(report)
    if cold["materialise"]["n_facts"] != oracle_facts:
        raise AssertionError(f"durable: {cold['materialise']['n_facts']} facts loaded, the "
                             f"flat oracle {oracle_facts}")
    if [e for e, _ in walls] != [DURABLE_EVERY] or crashed.epoch != DURABLE_EVERY + 1:
        raise AssertionError(f"durable: checkpoints {walls}, crashed at epoch {crashed.epoch}")
    mgr = CheckpointManager(str(root), label=f"lubm:scale{SERVE_SCALE}")
    snap = Path(mgr.latest())
    if snap.name != f"snap-{DURABLE_EVERY:08d}" or len(mgr.wal.records()) != 1:
        raise AssertionError(f"durable: latest {snap.name}, {len(mgr.wal.records())} WAL "
                             "records")
    if not (snap / "provenance.json").is_file():
        raise AssertionError(f"durable: {snap.name} holds no provenance.json")
    sidecar_records = len(json.loads((snap / "provenance.json").read_text())["records"])
    out.update({
        "wall_s": wall,
        "load_s": cold["materialise"]["seconds"],
        "checkpoint_s": walls[0][1],
        "snapshot_disk_bytes": snapshot_nbytes(str(snap)),
        "snapshot_data_bytes": (snap / "data.bin").stat().st_size,
        "wal_bytes": mgr.wal.nbytes(),
        "launches": launches,
        "largest_launch": ops.largest_launches(),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    })

    # the restore run, its restore's host synchronisations counted
    real_restore = CheckpointManager.restore
    real_load = CheckpointManager._load_provenance
    loaded = []

    def restore(self, program, **kwargs):
        result, out["restore_syncs"] = _count_syncs(
            lambda: real_restore(self, program, **kwargs))
        return result

    def load_provenance(self, snap_dir):
        loaded.append(real_load(self, snap_dir))
        return loaded[-1]

    CheckpointManager.restore = restore
    CheckpointManager._load_provenance = load_provenance
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        served, blocks, _ = _serve_explaining(
            [*_live_argv(SERVE_SCALE, DURABLE_RESTORE_QUERIES), *PROVENANCE_FLAGS,
             "--checkpoint-dir", str(root), "--restore"])
    finally:
        CheckpointManager.restore = real_restore
        CheckpointManager._load_provenance = real_load
    torch.cuda.synchronize()
    restore_wall = time.perf_counter() - t0
    rst = blocks["restore"]
    if (rst["snapshot_epoch"], rst["storage.wal_replayed"], rst["final_epoch"]) != (
            DURABLE_EVERY, 1, DURABLE_EVERY + 1):
        raise AssertionError(f"durable: restore {rst}")
    if not blocks["live-verify"]["ok"]:
        raise AssertionError("durable: live-verify failed after the restore")
    want, got = crashed.to_dict(), served.inc.to_dict()
    if set(want) != set(got) or not all(torch.equal(want[p], got[p]) for p in want):
        raise AssertionError("durable: the restored store differs from the crashed one")
    if served.inc.store.n_nodes() > crashed.store.n_nodes():
        raise AssertionError("durable: the restored store holds more nodes than the crashed")
    prov = blocks["provenance"]
    if loaded != [True]:
        raise AssertionError(f"durable: the restore loaded its sidecar {loaded}")
    if prov["records"] <= sidecar_records:
        raise AssertionError(f"durable: {prov['records']} records after the replayed batch, "
                             f"{sidecar_records} in the sidecar")
    if len(prov["explanations"]) != SERVE_EXPLAINS or not all(
            e["found"] and e["verified"] for e in prov["explanations"]):
        raise AssertionError(f"durable: explanations {prov['explanations']}")
    out.update({
        "restore_wall_s": restore_wall,
        "restore_s": rst["seconds"],
        "restore_snapshot_s": rst["storage.restore_snapshot_s"],
        "restore_replay_s": rst["storage.restore_replay_s"],
        "restore_epochs": [rst["snapshot_epoch"], rst["final_epoch"]],
        "wal_replayed": rst["storage.wal_replayed"],
        "nodes_crashed": crashed.store.n_nodes(),
        "nodes_restored": served.inc.store.n_nodes(),
        "verified_facts": blocks["live-verify"]["facts"],
        "restore_launches": launch_counts(),
        "restore_largest_launch": ops.largest_launches(),
        "provenance": {"crashed_records": crashed_records[0],
                       "sidecar_records": sidecar_records,
                       "restored_records": prov["records"],
                       "journal_bytes": prov["journal_bytes"],
                       "explanations": prov["explanations"], "hot_rules": prov["hot_rules"]},
    })
    log(f"[durable] {' '.join(argv)}: {out}")
    log(f"[durable] [restore] warm start from epoch {DURABLE_EVERY}, 1 WAL batch replayed, "
        f"epoch {DURABLE_EVERY + 1}, equal to the crashed store; [live-verify] OK; "
        f"checkpoint {out['checkpoint_s']:.3f} s, snapshot {out['snapshot_disk_bytes']} B; "
        f"restore {out['restore_snapshot_s']:.3f} s + replay {out['restore_replay_s']:.3f} s "
        f"against the cold load + materialise {out['load_s']:.3f} s; restore syncs "
        f"{out['restore_syncs']}; provenance.json in snap-{DURABLE_EVERY} "
        f"({sidecar_records} records) loaded by the restore, {SERVE_EXPLAINS} "
        f"explanations after the replayed batch verified")
    del served, crashed
    return out


def run_mvcc(tmp: Path) -> dict:
    """Phase 14: ``--mvcc --concurrency 4 --live`` at ``--scale 10000``,
    warm-started from the durable phase's directory and checkpointing
    every ``MVCC_EVERY`` batches: zero stale reads, the tier's epoch the
    restored epoch plus the batches applied, ``[live-verify] OK``."""
    import torch

    from repro_torch.kernels import ops

    argv = [*_live_argv(SERVE_SCALE, MVCC_QUERIES, MVCC_UPDATE_EVERY), "--mvcc", "--concurrency",
            str(MVCC_CLIENTS), "--checkpoint-dir", str(tmp / "durable"),
            "--checkpoint-every", str(MVCC_EVERY), "--restore"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    served, blocks = _serve(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    st = served.tier.stats()
    if "restore" not in blocks or served.recovery is None:
        raise AssertionError("mvcc: no warm start")
    from repro_torch.obs.provenance import get_journal

    # the snapshot it started from holds a sidecar; the journal is off here
    if not (Path(served.recovery.snapshot) / "provenance.json").is_file() or (
            get_journal().records):
        raise AssertionError("mvcc: a sidecar was loaded with the journal off, or none "
                             "was there")
    if st["stale_reads"] or blocks["serving"]["stale_reads"]:
        raise AssertionError(f"mvcc: {st['stale_reads']} stale reads")
    if not blocks["live-verify"]["ok"]:
        raise AssertionError("mvcc: live-verify failed")
    if st["epoch"] != served.recovery.final_epoch + served.applied or served.applied < 1:
        raise AssertionError(f"mvcc: tier epoch {st['epoch']} after {served.applied} batches "
                             f"from epoch {served.recovery.final_epoch}")
    _check_launched("mvcc", launches)
    out = {
        "wall_s": wall,
        "restore_s": blocks["restore"]["seconds"],
        "start_epoch": served.recovery.final_epoch,
        "batches": served.applied,
        "epoch": st["epoch"],
        "queries": blocks["serve"]["queries"],
        "qps": blocks["serve"]["qps"],
        **_percentiles(served.latencies_s),
        **{f"apply_{k}": v for k, v in _percentiles(served.apply_s).items()},
        "apply_s": served.apply_s,
        "stale_reads": st["stale_reads"],
        "epochs_published": st["epochs_published"],
        "epochs_retired": st["epochs_retired"],
        "peak_pinned": served.tier.registry.max_pinned,
        "micro_batches": st["batches"],
        "mean_batch": st["mean_batch"],
        "checkpoints": blocks["storage"]["storage.checkpoints"],
        "verified_facts": blocks["live-verify"]["facts"],
        "launches": launches,
        "largest_launch": ops.largest_launches(),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
    log(f"[mvcc] {' '.join(argv)}: {out}")
    log(f"[mvcc] warm start at epoch {out['start_epoch']}, {out['batches']} batches through "
        f"the writer to epoch {out['epoch']}, 0 stale reads, [live-verify] OK")
    del served
    return out


def run_serve_distributed() -> dict:
    """Phase 15: ``--distributed`` at ``--scale 270``, static (``[dist-verify]
    OK`` after the materialise) and ``--live`` (``[dist-verify] OK`` after
    the batches, ``[live-verify] OK``)."""
    import torch

    from repro_torch.kernels import ops

    out: dict = {}
    for mode, extra in (("static", ["--n-queries", str(LIVE_EVERY)]),
                        ("live", _live_argv(DIST_SERVE_SCALE, LIVE_QUERIES)[4:])):
        argv = ["--kb", "lubm", "--scale", str(DIST_SERVE_SCALE), *extra, "--distributed"]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        served, blocks = _serve(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not blocks.get("dist-verify", {}).get("dist.verify_ok"):
            raise AssertionError(f"distributed {mode}: no [dist-verify] OK")
        launches = launch_counts()
        missing = [k for k in ("sorted_member", "join_bounds") if not launches[k]]
        if missing:
            raise AssertionError(f"distributed {mode}: never launched {missing}")
        # the server's own shard count: one a visible card
        if served.dist.n_shards != torch.cuda.device_count():
            raise AssertionError(f"distributed {mode}: {served.dist.n_shards} shards on "
                                 f"{torch.cuda.device_count()} card(s)")
        entry = {
            "n_shards": served.dist.n_shards,
            "wall_s": wall,
            "host_load_s": blocks["materialise"]["seconds"],
            "dist_materialise_s": served.dist_materialise_s,
            "dist_rounds": served.dist.rounds,
            "n_facts": blocks["materialise"]["n_facts"],
            "launches": launches,
            "largest_launch": ops.largest_launches(),
        }
        if mode == "live":
            if not blocks["live-verify"]["ok"] or len(served.dist_apply_s) < 4:
                raise AssertionError(f"distributed live: {len(served.dist_apply_s)} batches, "
                                     f"live-verify {blocks['live-verify']}")
            entry.update({
                "dist_apply_s": served.dist_apply_s,
                **{f"dist_apply_{k}": v
                   for k, v in _percentiles(served.dist_apply_s).items()},
                "batches": served.applied,
            })
        out[mode] = entry
        log(f"[serve-distributed] {' '.join(argv)}: {entry}")
        log(f"[serve-distributed] {mode}: [dist-verify] OK")
        del served
    return out


def larger_launches(base: dict[str, dict], runs: dict[str, dict]) -> dict[str, dict]:
    """``runs`` cut to the kernels whose largest launch there moves more
    elements than that kernel's largest launch in every ``base`` run."""

    def size(shape: dict) -> int:
        return sum(shape.values())

    out = {}
    for path, run in runs.items():
        largest = {
            name: shape
            for name, shape in run["largest_launch"].items()
            if shape and all(size(shape) > size(b["largest_launch"][name]) for b in base.values())
        }
        out[path] = {"largest_launch": largest}
    return out


def check_server_launches(dev, runs: dict[str, dict]) -> dict[str, list]:
    """The largest launch of ``sorted_member``, ``join_bounds`` and
    ``rle_expand`` in each server phase (``runs``: path -> its numbers):
    the kernel held against its plain version exactly and timed against
    its library call in alternating turns, event-timed, with its host
    time, the plain version's time and the bytes bound.  No profiler trace
    is taken here: in earlier runs, traces taken after the full-size
    server phases lost device events (PERF.md §7), so the device-only
    times and the checks of which kernels ran stay with phase 12, which
    runs before them."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import ops, ref
    from repro_torch.roofline.analysis import HBM_BW

    out: dict[str, list] = {}
    for name in ("sorted_member", "join_bounds", "rle_expand"):
        kernel, plain = getattr(kernels, name), getattr(ref, name)
        for path, run in runs.items():
            shape = run["largest_launch"].get(name)
            if not shape:
                continue
            rng = np.random.default_rng([ops.KERNELS.index(name), 8, 2])
            args = _timed_args(name, path, shape, torch.int64, dev, rng)
            err = _compare(name, path, "int64", _as_list(kernel(*args)), _as_list(plain(*args)))
            call = main_path_call(name, kernel, args)
            ms, library_ms = alternating_ms(call, _library_call(name, args))
            entry = {
                "case": path,
                "dtype": "int64",
                "shape": dict(shape),
                "ms": ms,
                "library_ms": library_ms,
                "device_ms": None,
                "library_device_ms": None,
                "host_ms": host_ms(call),
                "plain_ms": cuda_ms(lambda: plain(*args)),
                "bound_ms": _bytes(name, args, 8) / HBM_BW * 1e3,
                "bound_by": "bytes",
                "max_abs_err": err,
            }
            log(f"[kernels] {name} int64 {path} {shape}: equal; {entry}")
            out.setdefault(name, []).append(entry)
    return out


def count_syncs(program, dataset) -> int:
    """Host synchronisations of one more full-size load + materialise,
    as CUDA's sync debug mode reports them."""
    import torch

    from repro_torch.core import CMatEngine

    def run():
        eng = CMatEngine(program, fused=True)
        eng.load(dataset)
        eng.materialise()

    return _count_syncs(run)[1]


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(
        evt, "self_cuda_time_total", 0.0
    )


def _profile_phases(program, dataset, dictionary):
    """``(label, prepare)`` for each traced phase: ``prepare()`` does the
    untraced set-up and returns the call to trace."""
    from repro_torch.core import CMatEngine
    from repro_torch.core.distributed import DistributedEngine
    from repro_torch.core.generators import lubm_like

    def cmat_load():
        eng = CMatEngine(program, fused=True)
        return lambda: eng.load(dataset)

    def cmat_materialise():
        eng = CMatEngine(program, fused=True)
        eng.load(dataset)
        return eng.materialise

    dist_program, dist_dataset, _ = lubm_like(**DIST_KB)
    dist_program = DistributedEngine.supported_program(dist_program)
    dist = DistributedEngine(dist_program, capacity=DIST_CAPACITY, join_capacity=DIST_CAPACITY)

    def dist_materialise():
        return lambda: dist.materialise(dist_dataset)

    def dist_apply():
        dels = {p: dist_dataset[p][: dist_dataset[p].shape[0] // 100]
                for p in ("takesCourse", "advisor")}
        return lambda: dist.apply(deletions=dels)

    def query_stream():
        from repro_torch.query import QueryEngine

        eng = CMatEngine(program, fused=True)
        eng.load(dataset)
        eng.materialise()
        qe = QueryEngine(eng, dictionary, result_cache_size=0)

        def run():
            for text in FULL_QUERIES:
                qe.answer(text)
            qe.answer_batch(FULL_BATCH)

        run()  # snapshots and plans built off the trace
        return run

    return [("load", cmat_load), ("materialise", cmat_materialise),
            ("query stream", query_stream),
            ("distributed materialise", dist_materialise),
            ("distributed apply", dist_apply)]


#: the hand kernels' entry names, as the profiler lists them
HAND_KERNELS = ("bucket_table_kernel", "bucket_probe_kernel", "empty_b_kernel",
                "join_bounds_table_kernel", "join_bounds_probe_kernel",
                "join_bounds_warp_kernel", "join_bounds_thread_kernel",
                "rle_expand_kernel", "merge_path_kernel", "merge_count_kernel",
                "fjd_kernel")


def _profile_call(phase: str, call) -> None:
    """Run ``call()`` once under ``torch.profiler`` and log its wall,
    device-busy time (kernels and copies as the card ran them) and its
    share of the wall, CUDA kernel launches issued, the top device and
    host operators, and the hand-written kernels' own device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    # host operators carry their kernels' device time too: count only
    # the device's own events, or it is counted twice
    dev = sorted((e for e in ka if e.device_type == DeviceType.CUDA),
                 key=_device_us, reverse=True)
    busy = sum(_device_us(e) for e in dev) / 1e6
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    log(f"[profile] {phase}: wall {wall:.3f} s under the profiler, device "
        f"busy {busy:.3f} s, busy share {busy / wall:.3f}, "
        f"cudaLaunchKernel {launches}")
    for e in dev[:8]:
        log(f"[profile] {phase} device: {_device_us(e) / 1e3:.1f} ms "
            f"{e.count} x {e.key[:70]}")
    for e in sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        log(f"[profile] {phase} host: {e.self_cpu_time_total / 1e3:.1f} ms "
            f"{e.count} x {e.key[:70]}")
    for e in dev:
        if any(k in e.key for k in HAND_KERNELS):
            log(f"[profile] {phase} hand kernel: {_device_us(e) / 1e3:.3f} ms "
                f"{e.count} x {e.key[:90]}")


def profile_run(program, dataset, dictionary) -> None:
    """Trace the CMat load and materialise, a pass of the query stream,
    and the distributed materialise and a 1 % delete ``apply``
    (:func:`_profile_call` each)."""
    for phase, prepare in _profile_phases(program, dataset, dictionary):
        call = prepare()
        _profile_call(phase, call)
        del call


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="trace the CMat, query and distributed runs once more "
                             "with torch.profiler")
    args = parser.parse_args()
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not beside {ROOT}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    # the join_bounds tuner's cache lives with this run, not in the home
    tune_dir = tempfile.TemporaryDirectory(prefix="repro_torch_tune_")
    os.environ[TUNE_CACHE_ENV] = str(Path(tune_dir.name) / "cuda_tune.json")
    from repro_torch.core.flat import flat_seminaive
    from repro_torch.core.generators import lubm_like
    from repro_torch.kernels import build, ops

    log(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t_build = build.build()
    log(f"[build] {len(build.SOURCES)} libraries in {t_build:.1f} s")

    models = run_models()
    train = run_train()
    sharding = run_sharding()
    # phase 1a (f)'s dry run needs no card: it runs beside phases 2-3,
    # which time nothing, and not beside the timed phases 1a-1a (e)
    step_dryrun = start_step_dryrun()
    try:
        check_small_workloads()
        check_small_queries()
        run_roofline(train, step_dryrun)
    finally:
        if step_dryrun.poll() is None:
            step_dryrun.kill()
            step_dryrun.wait()

    program, dataset, dictionary = lubm_like(
        n_dept=N_DEPT, n_students=N_STUDENTS, n_courses=N_COURSES
    )
    n_explicit = sum(int(v.shape[0]) for v in dataset.values())
    log(f"[full] lubm_like({N_DEPT}, {N_STUDENTS}, {N_COURSES}): "
        f"{n_explicit} explicit triples")
    full = run_full(program, dataset)
    t0 = time.perf_counter()
    oracle = flat_seminaive(program, dataset, device="cpu")
    log(f"[full] flat oracle on the CPU: {time.perf_counter() - t0:.1f} s, "
        f"{sum(int(v.shape[0]) for v in oracle.values())} facts")
    if not _facts_equal(full["engine"].materialisation(), oracle):
        raise AssertionError("full run: fact set differs from flat_seminaive")
    log("[full] fact set equals flat_seminaive")
    query = run_queries(full["engine"], oracle, dictionary)
    del full["engine"]
    torch.cuda.empty_cache()
    prov = run_provenance(program, dataset, full, oracle)
    del oracle
    torch.cuda.empty_cache()

    check_small_distributed()
    dist = run_full_distributed()
    dist4 = run_full_distributed(4, dist.pop("oracles"))
    del dist4["engine"], dist4["oracles"]
    log(f"[full-distributed] walls, 1 / 4 shards: materialise {dist['materialise_s']:.3f} / "
        f"{dist4['materialise_s']:.3f} s, apply delete {dist['apply_s']['delete']:.3f} / "
        f"{dist4['apply_s']['delete']:.3f} s, re-add {dist['apply_s']['re-add']:.3f} / "
        f"{dist4['apply_s']['re-add']:.3f} s")
    run_examples()
    closure = run_closure(dist.pop("engine"))
    torch.cuda.empty_cache()

    shapes = dict(full["largest_launch"])
    shapes["fused_join_dedup"] = closure["largest_launch"]["fused_join_dedup"]
    # sorted_member and join_bounds launch mostly on the distributed paths:
    # time them at the largest launches of the 1-shard apply and of the
    # 4-shard materialise and apply too, in the engine's int32 keys;
    # join_bounds also at the CMat run's own launches, and the merge at
    # the closure's largest (int32, into a buffer that holds codes)
    closure_merge = closure["largest_launch"]["merge_sorted_unique"]
    if not closure_merge.get("count"):
        raise AssertionError(f"the closure's largest merge holds no codes: {closure_merge}")
    # the query phase's kernels also at its largest launch each, and
    # sorted_member and join_bounds at its one-sided shapes: one key
    # against a snapshot column as long as the widest it searched, one
    # constant against a long candidate slice
    one_constant = {"n": max(query["one_constant_n"], QUERY_LONG_SLICE), "m": 1}
    # and the training corpus build's largest launch each (its CMatEngine's
    # int64 keys)
    train_largest = train["full"]["corpus_largest"]
    extra = {
        "sorted_member": [
            ("distributed-apply", dist["apply_largest"]["sorted_member"], (torch.int32,)),
            ("distributed-4", dist4["largest"]["sorted_member"], (torch.int32,)),
            ("distributed-4-apply", dist4["apply_largest"]["sorted_member"], (torch.int32,)),
            ("query", query["largest_launch"]["sorted_member"], (torch.int64,)),
            ("query-one-constant", one_constant, (torch.int64,)),
            ("train", train_largest["sorted_member"], (torch.int64,)),
        ],
        "join_bounds": [
            ("cmat-disjoint", CMAT_DISJOINT, (torch.int64,)),
            ("cmat-xjoin", CMAT_XJOIN, (torch.int64,)),
            ("distributed-apply", dist["apply_largest"]["join_bounds"], (torch.int32,)),
            ("distributed-4", dist4["largest"]["join_bounds"], (torch.int32,)),
            ("distributed-4-apply", dist4["apply_largest"]["join_bounds"], (torch.int32,)),
            ("query", query["largest_launch"]["join_bounds"], (torch.int64,)),
            ("query-one-key", {"n": 1, "m": query["one_key_m"]}, (torch.int64,)),
            ("train", train_largest["join_bounds"], (torch.int64,)),
        ],
        "rle_expand": [("query", query["largest_launch"]["rle_expand"], (torch.int64,)),
                       ("train", train_largest["rle_expand"], (torch.int64,))],
        "merge_sorted_unique": [("closure", closure_merge, (torch.int32,))],
        # each of the closure's own launches, the regrow's cut first calls
        # and the one that matches nothing among them
        "fused_join_dedup": [(f"closure-{j['head']}-{j['capacity']}", j, (torch.int32,))
                             for j in closure["joins"]],
    }
    # a path on which every launch of a kernel searched an empty side (the
    # 4-shard materialise's sorted_member) has no largest launch: the
    # ``empty-b`` edge case holds that path
    extra = {name: [e for e in cases if e[1]] for name, cases in extra.items()}
    kernel_numbers = check_kernels(torch.device("cuda"), shapes, extra)
    kernel_numbers["join_bounds"]["path_sweep"] = sweep_join_bounds(torch.device("cuda"))

    check_small_serve()
    serve_program, serve_dataset, _ = lubm_like(
        n_dept=4 * SERVE_SCALE, n_students=100 * SERVE_SCALE, n_courses=8 * SERVE_SCALE
    )
    t0 = time.perf_counter()
    serve_oracle = flat_seminaive(serve_program, serve_dataset, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] flat oracle of --scale {SERVE_SCALE} on the card (plain versions only): "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{sum(int(v.shape[0]) for v in serve_oracle.values())} facts")
    serve = run_serve(serve_oracle)
    del serve_oracle, serve_program, serve_dataset
    torch.cuda.empty_cache()
    live = run_live(serve["n_facts"], args.profile)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        durable = run_durable(Path(tmp), serve["n_facts"])
        torch.cuda.empty_cache()
        mvcc = run_mvcc(Path(tmp))
    torch.cuda.empty_cache()
    serve_dist = run_serve_distributed()
    torch.cuda.empty_cache()

    # the new phases' launches are timed where they are larger than phases
    # 11 and 12's
    server_runs = {"serve": serve, "live": live}
    server_runs.update(larger_launches(server_runs, {
        "durable": durable, "restore": {"largest_launch": durable["restore_largest_launch"]},
        "mvcc": mvcc, "serve-distributed": serve_dist["live"]}))
    for name, entries in check_server_launches(torch.device("cuda"), server_runs).items():
        kernel_numbers[name]["timings"] += entries
        kernel_numbers[name]["max_abs_err"] = max(
            kernel_numbers[name]["max_abs_err"], *(e["max_abs_err"] for e in entries))

    syncs = count_syncs(program, dataset)
    log(f"[syncs] host synchronisations in load + materialise: {syncs}")
    if prov["syncs_journal_off"] != syncs:
        raise AssertionError(f"provenance: {prov['syncs_journal_off']} syncs with the journal "
                             f"off, {syncs} here")
    if args.profile:
        profile_run(program, dataset, dictionary)

    paths = {
        "models": models["launches"],
        "train": train["launches"],
        "sharding": sharding["launches"],
        "cmat": full["launches"],
        "query": query["launches"],
        "provenance": prov["launches"],
        "distributed": dist["launches"],
        "distributed_apply": dist["apply_launches"],
        "distributed_4": dist4["launches"],
        "distributed_4_apply": dist4["apply_launches"],
        "closure": closure["launches"],
        "serve": serve["launches"],
        "live": live["launches"],
        "durable": durable["launches"],
        "restore": durable["restore_launches"],
        "mvcc": mvcc["launches"],
        "serve_distributed_static": serve_dist["static"]["launches"],
        "serve_distributed_live": serve_dist["live"]["launches"],
    }
    kernels_line = []
    for name in ops.KERNELS:
        num = kernel_numbers[name]
        by_path = {path: counts[name] for path, counts in paths.items()}
        kernels_line.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": num["max_abs_err"],
            "ms": num["ms"],
            "plain_ms": num["plain_ms"],
            "bound_ms": num["bound_ms"],
            "bound_by": num["bound_by"],
            "library_ms": num["library_ms"],
            "library_call": LIBRARY_CALLS[name],
            "shape": num["shape"],
            "dtype": num["dtype"],
            "device_ms": num["device_ms"],
            "library_device_ms": num["library_device_ms"],
            "host_ms": num["host_ms"],
            "timings": num["timings"],
            **({"path_sweep": num["path_sweep"]} if "path_sweep" in num else {}),
        })
    tune_dir.cleanup()
    log(f"[tune] inside main-path runs: {sum(t['sweeps'] for _, t in TUNING_IN_RUNS)} "
        f"join_bounds sweeps, {sum(t['launches'] for _, t in TUNING_IN_RUNS)} launches, "
        f"{sum(t['seconds'] for _, t in TUNING_IN_RUNS):.4f} s in all, over "
        f"{[run for run, _ in TUNING_IN_RUNS]}")
    log("[total] done")
    print(json.dumps({"kernels": kernels_line}))
    print(nvidia_smi())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
