#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. build   — compile the CUDA kernels from ``modelmesh_tpu_torch/csrc``
             (nvcc, sm_90a, one process per source, all at once) and print
             the card's name and power limit.
2. kernels — each sparse kernel against its plain PyTorch version on the
             card at the 100k x 1k tier's padded shape (C bf16[131072, 1024]
             from a seed; the top-K selection with K = 24, and the
             mask-only mode on its thresholds), at the
             wide path's [12288, 1536] (two column slabs, the cp.async ring),
             at a ragged [1000, 1001] and an odd [1000, 1537] (scalar loads,
             the register stage), and on 4096 rows of tied costs (hundreds
             of candidates a row) 1024 and 1536 wide: the selection's ids,
             thresholds, rowmin and packed mask bits bitwise (and the share
             of entries whose exact key it computed), the mask-only mode's
             rowmin and bits bitwise, the flat-integrand candidate counts of the
             row, column and fused products exact, the products at rtol 1e-5
             / atol 1e-6; time per launch over a run of 20 at the shape each
             kernel's path gives it (the column-only pass: the wide path's;
             it and the row-only pass also at the other shape), the fused
             step beside the row and column products back to back, and the
             column passes' device time split between the pass and the
             combine of its block partials (profiler); the selection beside
             the unfused route it replaces (PyTorch-op key, stable top-K,
             K-th key, the mask-only kernel). The guard band's draw bound,
             checked over all 2^24 uniforms. The implied-load kernel at the
             auctions' shape (int64[131072, 8] -> 1024, the sparse
             auction's 5-slot view, 1536 instances): bitwise at integer
             sizes, rtol 1e-6 at f32 sizes, two launches bitwise, timed
             beside index_add_.
   lse_kernels — the row-only, column-only and fused LSE kernels against
             their plain versions at the tier, at the dense tier's real
             widths ([131072, 128], [1000, 96], [1000, 64]), at a ragged
             [1000, 1001] and, the column-only kernel's slabs, at the wide
             path's [12288, 1536] and an odd [1000, 1537] (LSE, running max
             and the fused step's f at atol 1e-4 / rtol 1e-5), the extreme
             case at the tier (C and shifts x 30: finite, rtol 1e-5), z of
             one row bit for bit; time per launch over a run of 20 at the
             tier, at [131072, 128] and at [12288, 1536], beside the bound,
             the plain version and torch.logsumexp over a materialized z;
             the fused step beside the row and column kernels back to back,
             and its device time split between pass and combine.
3. main    — the production dispatch at 100,000 models x 1,000 instances
             (synthetic fleet at 85% utilization): snapshot_columns ->
             dispatch_solve -> finalize_plan on the sparse path, one warm-up
             then 5 solves with varied seeds, kernel launch counters zeroed
             just before (per solve one selection, no mask-only pass, one
             implied load per auction iteration and one more); two solves
             with one seed byte-identical.
   profile — one more main-path solve under torch.profiler: device time
             by kernel name and the device's idle share of the solve.
4. parity  — one 20,000 x 256 snapshot solved on the card and on the CPU
             (plain versions): placement agreement >= 0.97 and overflow
             within 0.5% of demand.
   wide    — the same at 10,000 x 1,200 (1536 padded instances, wider than
             the fused step's 1024 columns, so each Sinkhorn iteration runs
             the row and column products back to back); the sparse launch
             counters are zeroed just before the card's solve and read just
             after: the column-only kernel's path.
5. dense_main — the same 100k x 1k fleet on the dense tier (the
             reference's "full Sinkhorn", pinned with MM_SOLVER_SPARSE=0
             around the phase): one warm-up, 5 solves with the default
             config, LSE launch counters zeroed just before (per solve: one
             fused step per Sinkhorn iteration, one row-only pass, no
             column-only pass, one host sync, one implied load per auction
             iteration and one more; two same-seed solves byte-identical);
             then one solve with the
             steady gates, and the tie-stable top-k against torch.sort /
             torch.topk at the auction's shortlist shape.
   dense_profile — one dense solve under torch.profiler.
6. dense_parity — a 10,000 x 128 snapshot, which the auto rule routes
             dense, on the card and on the CPU, with phase 4's gates.
7. dense_wide — the wide fleet (10,000 x 1,200, 1536 padded columns)
             pinned dense, on the card and on the CPU, with phase 4's
             gates: the row and column LSE back to back on every
             iteration, no fused step; the column-only kernel's path.
8. steady — the steady state at the main fleet (bench.py's
             _measure_solver_paths, run_path("1", 0.05) and
             run_path("1", 0.0)) through ``TorchPlacementStrategy``, the
             records kept and churned: each cycle 1,000 models (n // 100,
             from the fleet's rng) get last_used = now and a fresh rpm,
             all marked dirty, then refresh(incremental=True). One
             throwaway refresh, a cold one and 6 cycles with the dirty-row
             re-solve allowed (incr_max_dirty_frac 0.05): at least 5
             incremental, fallbacks counted; each incremental refresh makes
             1 host sync, stays within the base's overflow + 0.5% of
             demand, and launches the row LSE (kernel 4) and the implied
             load once each and nothing else (counters zeroed just before
             each refresh). Two re-solves on one base byte-identical; one
             more refresh staged by hand (patch, expansion, sizes @ loaded,
             cost rows, re-solve, readback, extraction) and profiled; the
             same churn with full warm sparse solves on delta snapshots
             (incr_max_dirty_frac 0); at 20,000 x 256, 3 cycles through a
             CPU and a CUDA strategy: both incremental at least once,
             agreement >= 0.97, overflow within 0.5% of demand; kernel 4
             at bf16 [1024, 1024] against its plain version, timed beside
             its bound and torch.logsumexp.
   pipelined — the pipelined steady refresh (placement/refresh_loop.py,
             PipelinedRefresher) at the main fleet under the sparse pin
             and the steady gates, beside the blocking refresh on the
             same churn (two fleets from one seed, 1,000 models a cycle):
             a cold blocking refresh and a priming submit, then 6 cycles,
             each running a blocking refresh(incremental=True) and a
             pipelined submit in turns (the blocking one first on even
             cycles), and the drain.
             Per pipelined cycle: submit wall ms, the dispatched flight's
             path, dirty rows and dispatch host ms, the emitted plan's
             wait on its readback event, host syncs (at most 1 on an
             incremental cycle) and launches (kernel 4 and the implied
             load once each and nothing else on an incremental cycle;
             counters zeroed just before each submit). Every generation
             emitted once, in order; incremental plans within the base's
             overflow + 0.5% of demand; at least 4 of 6 cycles
             incremental; medians and maxima of both runs' wall times,
             and the cycle-by-cycle difference.
             Then the pipelined sequence at 20,000 x 256 (3 cycles) on the
             card and on the CPU: paths equal, agreement >= 0.97,
             overflow within 0.5% of demand.
9. threefry — JAX's threefry Gumbel draw (csrc/threefry.cu) against its
             plain version (modelmesh_tpu_torch/random.py) on the card,
             bits and Gumbel values bitwise, at [4096, 1024] and a ragged
             [1000, 1001], and the card's bits against the CPU's; time per
             launch over 20 at [131072, 1024] beside its bound, the plain
             version and torch.rand + two logs; one dense solve of the main
             fleet pinned dense with noise_impl="threefry" at tau 1
             (launch counters zeroed just before it: one draw a solve); the
             dense parity fleet (10,000 x 128) under the pin on the card
             and on the CPU, with phase 4's gates.
10. sharded — the sharded solve (parallel/sharded_solver.py), every
             shard on this card, one thread each. First each column
             reduction's partial route at C bf16[131072, 1024] on an 8 x 1
             mesh (the fused sparse pass, the column-only product, the
             fused LSE step, the column LSE, the implied load at
             int64[131072, 8] -> 1024): the shards' block partials
             combined once, bit for bit the wrapper on the whole of C.
             Then the main fleet through dispatch_solve(mesh=...) ->
             finalize_plan on meshes 1x1, 8x1, 4x2 and 2x4 on the sparse
             path, and 1x1, 8x1 and 4x2 pinned dense: per shape a warm-up
             and 3 solves at one seed (launch counters zeroed just before
             them, read just after), the wall ms, solve_ms, launches per
             kernel per solve, host syncs and peak device memory. Sparse
             1x1 and dense 1x1 and 8x1 must be byte for byte the
             single-device solve's indices and valid; every other shape
             prints the rows that differ, the largest |dg| and the reason,
             and must hold agreement >= 0.97 and overflow within 0.5% of
             demand. One sparse 8x1 solve profiled (device busy and idle
             share). One 8x1 dense solve under the threefry pin (each
             shard folds its index into the key: 8 draws a solve; another
             draw, held to the overflow gate).
11. models — a model server answering requests on the card:
             start_torch_runtime(device="cuda:0") on localhost, driven
             through the port's stub (RuntimeStatus, LoadModel, Predict,
             ModelSize, UnloadModel) for each family at its default spec,
             transformer://d=64,heads=4,seq=128,layers=2 and the MoE
             transformers transformer://experts=8 and
             transformer://d=64,heads=4,seq=64,layers=2,experts=16,groups=8
             (parallel/moe.py's dense oracle): load time, weights byte
             for byte against a CPU build, logits against the CPU path
             (for MoE: every token's expert against the CPU's, a token
             routed otherwise reported with its top-2 margin, which must
             be a near-tie, and the logits compared where routing
             agrees), Predict latency over the loopback (median of 50).
             Then InProcessTorchLoader on the card: a same-model
             micro-batch of 8 requests, fused groups of 8 mlps and 8
             transformers (one fused dispatch each, no fallback, equal to
             the per-model path within the family's tolerance; fused
             against per-model dispatch timed, one of each profiled: the
             device's busy time and idle share), MoE batches of 2 (one
             model, and two models of one architecture) run per request
             and equal to solo calls bit for bit, and a load from a CPU
             loader's weight stream.

12. runtime_mesh — the model runtime across a mesh of 8 shards, every
             shard on this card with one worker thread each (as phase
             sharded); no custom kernel runs here (the launch counters are
             zeroed before it and read after: all 0). (a) Ring attention
             (parallel/ring_attention.py) at [1, 2, 128, 8], [2, 4, 128, 32]
             and [1, 4, 8192, 32], causal and not, f32 and bf16: against
             reference_attention on the card (f32 2e-5, bf16 3e-2, TF32
             off), the f32 rings against the same ring on 8 CPU shards
             (2e-5; the long sequence causal only), 2·(n−1) = 14 ppermutes
             a call from the mesh's counter; the ring's and the oracle's
             wall ms. (b) The expert-parallel FFN (parallel/moe.py), 16
             experts over 8 shards at d=32, ff=64, T=128 and d=128,
             ff=512, T=4096: every shard's routing (expert, slot, drop)
             bit for bit the dense oracle's group on the card, outputs at
             rtol 1e-5 / atol 1e-5·max|oracle|, 2 all_to_alls a call;
             wall ms beside the oracle's. (c) The sp=1 and ep=1
             transformers (seq=128,sp=1; d=64,heads=4,seq=128,layers=2,
             sp=1; experts=16,groups=8,ep=1; d=64,heads=4,seq=64,layers=2,
             experts=16,groups=8,ep=1) served over gRPC by
             start_torch_runtime(device="cuda:0", devices=["cuda:0"] * 8)
             and by InProcessTorchLoader(devices=...): logits against the
             same spec on one device (0.08, the reference's) and on 8 CPU
             shards (1e-2, where every token routes as on the CPU; a token
             routed otherwise must be a near-tie), the collectives of one
             Predict (the ring's ppermutes or the exchange's all_to_alls,
             per layer); Predict median and maximum of 50 beside the
             one-device model's. (d) The serving mesh: transformer:// and
             mlp:// through load_shard over 1, 4 and 8 shards: 1 shard bit
             for bit the plain load, 4 and 8 within 1e-5; the bytes each
             shard holds equal its blocks plus the replicated leaves, each
             split block in storage of its own, the reported share
             ceil(total/n); a shard's export_shard_weights ->
             load_shard_from_stream round trip byte for byte; Predict ms
             against the plain load. (e) The mesh's own cost: an empty
             run, 14 ppermutes, the same with one device op each, a small
             ring (mesh_costs).

13. plan_loop — the registry and the leader/follower plan loop at the
             main fleet (100,000 models x 1,000 instances, the main
             phase's records and seed): the models written as port
             records through a BucketedKVTable under mm/registry, the
             instances through a KVTable under mm/instances, all into one
             port InMemoryKV; three pods, each a TorchPlacementStrategy on
             the card with its default (greedy) fallback, a SessionNode
             for its own instance record (2 s TTL), a LeaderElection, a
             PlanFollower and a TableView of the instances. Five ticks of
             the reaper's plan step (serving/tasks.py reaper_plan_step) on
             the elected leader, and one more under torch.profiler (the
             device's idle share of a tick): per tick the registry scan,
             the views, the refresh and its solve_ms, the publish and the
             plan's bytes, each pod's adoption from the put's return,
             host syncs and launches per kernel (counters zeroed just
             before the step). Gates: every tick's generation one more
             than the KV held; every pod's adopted plan to_bytes() equal
             to the published bytes; the leader's plan byte for byte
             dispatch_solve -> finalize_plan on the snapshot its refresh
             built, with its refresh's seed and carry, and that snapshot
             the scanned records' in every column not read against the
             clock (rates of models without rpm, LRU ages). A
             follower's load decisions on 1,000 models: the plan's answer
             wherever the plan has a usable target, else greedy's (share
             and µs of each). A shadow pod,
             ShadowStrategy(GreedyStrategy(), TorchPlacementStrategy()),
             scores the same decisions (agreement). One tick under
             MM_MAX_PLAN_BYTES at a quarter of the plan's bytes: every pod
             holds exactly the kept models, a cut model is answered by
             greedy. The leader leaves (election and session closed): a
             follower leads within the TTL, and its tick publishes the
             next plan (its generation is the new leader's own refresh
             count, as in the reference). One tick of a 10,000 x 100 fleet
             on the dense tier (lse_sinkhorn_step launched). Under 90 s.

14. instance — the serving instance on the card: four port
             ModelMeshInstance pods on one port InMemoryKV, each with its
             own InProcessTorchLoader on the card (capacity 1/8 of the
             registry's bytes as built) and a TorchPlacementStrategy on
             the card (greedy fallback, plan follower); peers and weight
             fetches called directly, with the wire's trace handoff;
             batch_max 8, peer fetch on. 256 models with seeded ids over
             MODEL_SPECS and MOE_SPECS in turn. The elected pod runs the
             reaper's plan step before the traffic and after 500 of its
             requests, the clients still sending
             (launch counters zeroed just before each: lse_sinkhorn_step,
             row_lse_partial and implied_load must launch; every pod
             adopts the published bytes). A transformer larger than any
             pod (transformer://d=1024,heads=8,layers=2) is placed and
             served as a sharded group (within SERVING_TOL of the full
             model). 8 client threads send 2,000 requests, Zipf(1.1) over
             the models, each entering at a uniformly drawn live pod; after
             1,000 one pod runs pre_shutdown (the drain) and leaves, the
             next 200 are profiled (the device's idle share). A fused burst
             (16 requests over models of one architecture on one pod, sent
             at once), a second copy of a transformer streamed from its
             holder (bitwise a store load), then quiescence: every
             registry record's instance_ids equal to the pods whose cache
             holds the model. Gates: every request answered (the burst's
             too, each one counted) and equal to a direct TorchModelStore
             predict on the card within MODEL_TOL, evictions, forwards and
             fused dispatches > 0, every load decision of a client request
             the adopted plan's wherever the plan has a usable target, and
             the request served where that copy landed unless its load or
             forward gave up, no copy loaded off the card. Prints latency by
             path (local hit, forwarded, miss with load, after the drain),
             loads, load ms, evictions, batch sizes, the plan's decisions
             and the leader steps' stages.

15. server — the serving pods over real localhost gRPC on the card, wired
             as the reference launcher wires them (serving/main.py): three
             port ModelMeshInstance pods on one port InMemoryKV (kv prefix
             mm), the first two each with an InProcessTorchLoader on the
             card, the third a SidecarRuntime in front of
             start_torch_runtime on the card (its weight fetches fall back
             to store loads); each a TorchPlacementStrategy on the card,
             BootstrapProbation.from_env(), an UpgradeTracker, peers
             through make_grpc_peer_call / make_grpc_peer_fetch over one
             shared PeerChannels, a MeshServer (port 0) with a
             VModelManager and build_processor([an http:// sink on
             localhost]), BackgroundTasks in burn mode at accelerated
             cadences (publisher 1 s, autoscaler 0.5 s, janitor 2 s,
             reaper 3 s), a ServingConfigBinder, a PreStopServer, and
             register_static_models (two linear models on the first pod).
             Every client call goes over gRPC: RegisterModel for 20 models
             (4 of each MODEL_SPECS family but linear), EnsureLoaded and
             GetModelStatus, 240 then 120 Zipf(1.1) Predicts from 4
             threads with the mm-model-id header, a vmodel set and rolled
             over to a new target with requests by mm-vmodel-id, an
             UnregisterModel at a pod without the copy (the holder drops
             it on the deletion watch) and another with the holder's watch
             listener detached (its janitor drops it). A burn injected
             into the leader's SLO window for the linear class (no client
             request records into it) makes its autoscaler add a copy.
             A non-leader pod drains through GET /prestop (the reference
             hook answers GET); its /ready then answers 503 and its
             models answer from the survivors. The launch counters are
             zeroed after the setup and read at the end; the reaper's
             step (serving/tasks.py reaper_plan_step) is recorded as the
             leader's BackgroundTasks call it. Gates: every answer equal
             to a direct TorchModelStore predict within MODEL_TOL; at
             least two of the leader's reaper ticks published a plan and
             every live pod adopted each one's bytes; the ticks launched
             lse_sinkhorn_step, row_lse_partial and implied_load; an
             autoscale-up in the leader's decision log and a copy more
             in the registry; both unregistered copies dropped, the
             second by the janitor's thread; the vmodel's active id moved
             to the new target; /ready 503 on the drained pod; the sink
             got a request and a response payload for every call; at
             quiescence every record's holders are the pods whose cache
             holds the model; the native splicer built and agreed with
             its Python path on 200 seeded messages (the runtime's
             payload is raw tensor bytes, with no id field for the
             in-body path); under 150 s. One server_stage line per stage.
16. cluster — launcher pods as separate processes on the card: the
             port's mesh:// KV server (kv/service.py, 64 workers) in this
             process, and three children, each ``cluster_pod`` (the
             launcher's main(argv) with --runtime torch --strategy torch
             and no --device, so the card is the default; its
             BackgroundTasks at the accelerated cadences CLUSTER_TASKS:
             publisher 1 s, janitor 2 s, reaper 3 s), started at once.
             SERVER_STATIC's two linear models come from the first pod's
             MM_STATIC_MODELS, 3 of each MODEL_SPECS spec over gRPC
             RegisterModel; 300 Zipf(1.1) Predicts from 4 threads over
             the pods' endpoints; a non-leader (by its ***STATE*** dump)
             drains on SIGTERM while 120 more Predicts go to the
             survivors, then each of its models once at a survivor; the
             survivors stop on SIGTERM. Each child prints, after main
             returns, its launch counters, devices, peak device memory,
             its reaper steps (launches, the published plan's generation
             and digest) and the plans its strategy held. Then two pods
             each over the port's etcd v3 wire server and its ZooKeeper
             wire server, side by side: 3 models, 30 Predicts, SIGTERM.
             Gates: every pod ready (spawn to READY timed), every pod's
             loader and strategy on cuda with device memory allocated,
             the card's used memory up by 256 MiB a pod with the pods
             up (nvidia-smi's process list is recorded; in a container with
             its own PID namespace it does not name the pods); every
             answer within MODEL_TOL of a direct TorchModelStore predict
             here; two plan generations published (read from the KV) and
             at least two ticks each adopted, byte for byte, by all three
             pods; every published tick launched lse_sinkhorn_step,
             row_lse_partial and implied_load; the drained pod exits 0
             and no request fails; at quiescence the registry read over
             RemoteKV equals the live pods' caches; every pod exits 0;
             under 150 s. One cluster_stage line per stage.
17. sim    — the port's simulator (modelmesh_tpu_torch/sim/) on the
             card's host, in child processes through its entry points; it
             takes no device and launches no kernel (the launch counters
             are zeroed in the child before its runs and read after: all
             0, CUDA never initialized there). (a) Every scripted
             scenario of scenarios.ALL once through run_all(), each
             one's verdict and wall time; (b) rolling_restart_under_zipf_load
             twice, trace_lines() equal; (c) ``python -m
             modelmesh_tpu_torch.sim --seed 0 --sweeps 8 --steps 40``: it
             runs to its end with a verdict a seed, and a seed that fails
             (seed 0 does, and others may, in the reference too: the
             explorer's findings) names its invariants and prints its
             replay line; (d) ``python -m
             modelmesh_tpu_torch.sim --macro`` at the macro headline's
             widths (1,000 pods, 1,000,000 users, 2,048 models, seed
             1700, burn authority with admission) over a virtual 1,200 s
             of its 86,400 s day, beside (a) to (c): exit 0, no
             conservation violation, offered = served + shed + failed,
             at least one request a user. Prints the digest, engine
             events, requests simulated and each part's wall time; under
             120 s.
18. import_order — the cuBLAS rule (modelmesh_tpu_torch/__init__.py) in
             two fresh processes without CUBLAS_WORKSPACE_CONFIG: one runs
             a cuBLAS product, imports the port and must be refused a
             CUDA TorchModelStore (RuntimeError naming the fix); one sets
             :0:0 first, runs a product, then tools/batch_parity.py (8
             payloads a spec): every batched and fused answer within
             1.2e-6 of max|solo|.

Then the card line from nvidia-smi, one JSON line with every kernel's
numbers, and, last, ``{"ok": true, "device": {...}}``. Without a CUDA
device it exits non-zero before printing any result.

``phase_sharded_cards`` is not part of this run: on a host with four
cards it holds meshes 4x1 and 2x2 across them against one card.
"""

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from modelmesh_tpu_torch import device as device_mod
from modelmesh_tpu_torch.ops import (
    _build, auction, cuda_lse, cuda_sparse, sparse,
)
from modelmesh_tpu_torch.ops.auction import K_CAND, MAX_COPIES
from modelmesh_tpu_torch.placement.synthetic import synthetic_records
from modelmesh_tpu_torch.placement.torch_engine import (
    TorchPlacementStrategy,
    dispatch_solve,
    finalize_plan,
    snapshot_columns,
    solve_config_from_env,
)
from modelmesh_tpu_torch.records import now_ms

SEED = 20260
TIER = (131072, 1024)          # _bucket(100_000) x _bucket(1_000, 64)
MAIN_FLEET = (100_000, 1_000)
PARITY_FLEET = (20_000, 256)
WIDE_FLEET = (10_000, 1_200)   # pads to 1536 columns: wider than the fused step
WIDE = (12288, 1536)           # the wide fleet's padded shape
RAGGED = (1000, 1001)
TIES_ROWS = 4096
DENSE_PARITY_FLEET = (10_000, 128)   # pads to 128 columns: auto routes dense
STEADY_UTILIZATION = 0.85
KERNEL_REPS = 20
MAIN_SOLVES = 5
# The steady cell: churn cycles per run, the incremental cycles the run
# must see, the parity fleet's cycles, and kernel 4's shape there (the
# dirty rows of one cycle padded to a bucket of 64).
STEADY_CYCLES = 6
STEADY_MIN_INCREMENTAL = 5
STEADY_PARITY_CYCLES = 3
STEADY_LSE_SHAPE = (1024, 1024)
# Published H100 peaks (NVIDIA data sheets): device memory bytes/s by part,
# and f32 operations/s outside the tensor cores. 32-bit integer operations
# issue on 64 INT32 lanes per SM against 128 FP32 lanes (the H100
# architecture whitepaper), and the f32 figure counts an FMA as two: a
# quarter of the f32 figure.
PEAK_BYTES_PER_S = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}
PEAK_F32_OPS_PER_S = 67e12
PEAK_INT32_OPS_PER_S = PEAK_F32_OPS_PER_S / 4
# f32 operations by the data sheet's count, per cost-matrix element and per
# candidate (set mask bit). select_candidates and masked_row_min: the
# selection key (uniform, clamp, two logs, two negations, scale, subtract),
# the mask test and the min, on every element. implied_load, per slot: the
# weight's multiply and the add. The bit-reading kernels: a bit test and a
# convert per element; per candidate a subtract, a divide, an exp and a
# multiply-add (the fused step one more multiply-add, for the column). The
# LSE kernels: subtract, scale, max, subtract, exp, add; the fused LSE step
# both reductions. The threefry Gumbel draw: the uniform's subtract, add
# and max, two logs and two negations.
OPS_PER_ELEMENT = {"select_candidates": 10, "masked_row_min": 10,
                   "masked_row_matvec": 2,
                   "masked_col_matvec": 2, "masked_sinkhorn_step": 2,
                   "row_lse_partial": 6, "col_lse_partial": 6,
                   "lse_sinkhorn_step": 12, "implied_load": 2,
                   "threefry_gumbel": 7}
# 32-bit integer operations per element. The selection key's hash (10).
# The threefry draw: 20 rounds of add, rotate, xor (60), 6 key injections
# of 2 adds and the counters' split (14), the XOR of the two words (1), the
# uniform's shift and or (2).
INT32_OPS_PER_ELEMENT = {"select_candidates": 10, "masked_row_min": 10,
                         "threefry_gumbel": 77}
OPS_PER_CANDIDATE = {"masked_row_matvec": 5, "masked_col_matvec": 5,
                     "masked_sinkhorn_step": 7}
REPLACES = {
    "select_candidates": "modelmesh_tpu/ops/pallas_sparse.py:196",
    "masked_row_min": "modelmesh_tpu/ops/pallas_sparse.py:196",
    "masked_row_matvec": "modelmesh_tpu/ops/pallas_sparse.py:226",
    "masked_col_matvec": "modelmesh_tpu/ops/pallas_sparse.py:260",
    "masked_sinkhorn_step": ("modelmesh_tpu/ops/pallas_sparse.py:226, "
                             "modelmesh_tpu/ops/pallas_sparse.py:260"),
    "row_lse_partial": "modelmesh_tpu/ops/pallas_lse.py:130",
    "col_lse_partial": "modelmesh_tpu/ops/pallas_lse.py:167",
    "lse_sinkhorn_step": ("modelmesh_tpu/ops/pallas_lse.py:130, "
                          "modelmesh_tpu/ops/pallas_lse.py:167"),
    # A TPU-only path, not a Pallas kernel.
    "implied_load": "modelmesh_tpu/ops/auction.py:144",
    # XLA's threefry (jax.random.gumbel), not a Pallas kernel.
    "threefry_gumbel": "modelmesh_tpu/ops/auction.py:337",
}
SOURCES = {"masked_sparse": "modelmesh_tpu_torch/csrc/masked_sparse.cu",
           "lse": "modelmesh_tpu_torch/csrc/lse.cu",
           "implied_load": "modelmesh_tpu_torch/csrc/implied_load.cu",
           "threefry": "modelmesh_tpu_torch/csrc/threefry.cu"}
LSE_EPS = 0.05
LSE_TOL = dict(atol=1e-4, rtol=1e-5)
# Where the LSE kernels are held against their plain versions: the tier,
# the dense tier's real widths (128 at 100k models; 96 and 64), ragged C,
# and the column-only kernel's slabs (the wide path's shape and an odd
# width); the extreme case runs at the tier.
LSE_SHAPES = {"tier": TIER, "narrow": (131072, 128), "w96": (1000, 96),
              "w64": (1000, 64), "ragged": RAGGED, "wide": WIDE,
              "wide_odd": (1000, 1537)}
LSE_TIMED = ("tier", "narrow", "wide")
SPARSE_EPS = 0.05
SPARSE_K = 24
SPARSE_TOL = dict(rtol=1e-5, atol=1e-6)
# The auctions' implied load at the main path's shape: N x MAX_COPIES slots
# onto the tier's instances, sizes as the synthetic fleet's (16-255).
LOAD_TOL = dict(rtol=1e-6, atol=0.0)
# The threefry draw: held bitwise against its plain version at these
# shapes (and the card's bits against the CPU's at the first), and in
# Gumbel values at the dense tier's [131072, 1024], where it is timed.
THREEFRY_SHAPES = {"block": (4096, 1024), "ragged": RAGGED}
# The model runtime: each family at its default spec, and the longest
# sequence the repo's tests serve; the fused groups' size; gRPC Predict
# calls timed per model; dispatch rounds timed per group.
MODEL_SPECS = [
    ("mlp", "mlp://"), ("linear", "linear://"), ("conv", "conv://"),
    ("embedding", "embedding://"), ("transformer", "transformer://"),
    ("transformer", "transformer://d=64,heads=4,seq=128,layers=2"),
]
# MoE transformers (experts > 0): the default widths with 8 experts, and
# tests/test_models.py's grouped spec. Their routing is an argmax, so the
# card's logits are compared with the CPU's where every token took the
# same expert; a token that took another is reported with the CPU's top-2
# probability margin, which must be a near-tie (MOE_TIE_MARGIN).
MOE_SPECS = [
    ("transformer", "transformer://experts=8"),
    ("transformer",
     "transformer://d=64,heads=4,seq=64,layers=2,experts=16,groups=8"),
]
MOE_TIE_MARGIN = 1e-3
# Card against CPU for the MoE transformers, as (rtol, atol / max|ref|).
# The reference rounds the experts' hidden activations to bf16 after an
# f32 product (parallel/moe.py::_expert_ffn), so another summation order
# (cuBLAS's) flips some of those roundings, each a bf16 ulp of a hidden
# unit: looser than the dense transformers' 1e-4, ten times tighter than
# the CPU tests' bf16-level 1e-2.
MOE_TOL = (0.0, 1e-3)
FUSED_GROUP = 8
# The fused groups held against solo calls: the layer-streamable families
# at their default specs, and the transformer spec whose fused answers
# cuBLAS's split-K once moved by 1.5e-4 of max|ref|.
FUSED_SPECS = [("mlp", "mlp://"), ("transformer", "transformer://"),
               ("transformer", "transformer://d=64,heads=4,seq=128,layers=2")]
PREDICT_CALLS = 50
DISPATCH_ROUNDS = 20
# Card against the port's CPU path, and batched or fused calls against
# solo ones on the card, per family, as (rtol, atol / max|ref|). Measured
# on an H100: conv and embedding equal, the transformers within 2.1e-6 of
# max|ref|, fused groups within 9.4e-7. Another summation order (cuBLAS's,
# a batched product's) moves f32 sums in the last bits; a product that ran
# in bf16 where the reference promotes it to f32 (or a TF32 matmul) would
# move the logits by ~1e-3 of max|ref| and fails. So does cuBLAS's split-K,
# which the port turns off (modelmesh_tpu_torch/__init__.py): with it, a
# fused group of 8 transformers (d=64, seq=128) answered 1.5e-4 of max|ref|
# from its solo calls (tools/batch_parity.py).
MODEL_TOL = {"mlp": (1e-5, 1e-5), "linear": (1e-5, 1e-5),
             "conv": (0.0, 1e-4), "embedding": (0.0, 1e-4),
             "transformer": (0.0, 1e-4)}


def load_ops():
    """The implied-load wrappers, imported where a phase needs them, so
    that tools/sparse_kernel_times.py can run this module's helpers on a
    tree from before them."""
    from modelmesh_tpu_torch.ops import cuda_load

    return cuda_load


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def peak_bytes_per_s(name: str) -> float:
    for part, rate in PEAK_BYTES_PER_S.items():
        if part in name:
            return rate
    return PEAK_BYTES_PER_S["SXM"]


def time_ms(fn, reps: int) -> float:
    """Device time of one ``fn``: CUDA events around ``reps`` runs back to
    back, over ``reps``, after a warm-up run. The host enqueues ahead of
    the card, so a short kernel is not charged its launch latency."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(name: str, nbytes: int, elements: int, card: str,
          candidates: int = 0) -> dict:
    """The least time the card could take: bytes over the memory rate, f32
    operations over the f32 rate, or integer operations over the INT32
    rate, whichever is largest. ``candidates``: this run's set mask bits,
    for the kernels whose work depends on them."""
    bytes_ms = nbytes / peak_bytes_per_s(card) * 1e3
    ops = (OPS_PER_ELEMENT[name] * elements
           + OPS_PER_CANDIDATE.get(name, 0) * candidates)
    int_ops = INT32_OPS_PER_ELEMENT.get(name, 0) * elements
    ops_ms = max(ops / PEAK_F32_OPS_PER_S,
                 int_ops / PEAK_INT32_OPS_PER_S) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes}


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build_all()
    # Per library: each kernel's entry line, then its registers and spills.
    ptxas = {
        lib: [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
              if "entry function" in ln or "registers" in ln
              or "spill" in ln]
        for lib, log in _build.build_log.items()
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds, "ptxas": ptxas})


def sparse_operands(C, seed=SEED):
    """Thresholds from the port's top-K gather of C (K = 24; no selection
    noise when ``seed`` is None)."""
    feasible = torch.ones(C.shape, dtype=torch.bool, device=C.device)
    _, _, _, fz = sparse.topk_candidates(C, feasible, SPARSE_K, seed=seed)
    return (C, fz.thresh, fz.x_row), dict(tau=fz.tau, noised=fz.noised)


def selection_operands(C, seed=SEED):
    """The gather's row hash state of C (selection noise at ``seed``,
    none when it is None) and the selection's keywords."""
    noised = seed is not None
    salted = 0 if seed is None else (seed ^ sparse._GATHER_SALT) & 0xFFFFFFFF
    x_row = cuda_sparse.noise_row_state(C.shape[0], salted, C.device)
    return x_row, dict(tau=sparse.GATHER_TAU, noised=noised)


def bitwise_differs(a, b) -> int:
    """Elements of a and b whose bits differ."""
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum().item())


def check_sparse_kernels(C, tag: str, seed=SEED) -> dict:
    """Every sparse kernel against its plain version on C: the selection's
    ids, thresholds, rowmin and bits bitwise, the mask-only mode's rowmin
    and bits on the plain thresholds bitwise, flat-integrand counts exact,
    products within SPARSE_TOL. Returns what phase_kernels times: the
    operands, the bit-reading kernels (name -> (kernel, plain version)),
    the candidate count, the errors and the selection's exact-key share."""
    n, m = C.shape
    x_row, kw = selection_operands(C, seed)
    exact = torch.zeros(n, dtype=torch.int32, device=C.device)
    sel = cuda_sparse.select_candidates(C, x_row, SPARSE_K,
                                        exact_counts=exact, **kw)
    sel_ref = cuda_sparse.select_candidates_ref(C, x_row, min(SPARSE_K, m),
                                                **kw)
    differs = {f: bitwise_differs(getattr(sel, f), getattr(sel_ref, f))
               for f in sel._fields}
    check(not any(differs.values()),
          f"{tag}: select_candidates differs bitwise from its plain version "
          f"({differs})")
    args = (C, sel_ref.thresh, x_row)
    rowmin, bits = cuda_sparse.masked_row_min(*args, **kw)
    rowmin_ref, bits_ref = cuda_sparse.masked_row_min_ref(*args, **kw)
    check(torch.equal(rowmin.view(torch.int32), rowmin_ref.view(torch.int32)),
          f"{tag}: masked_row_min differs bitwise from its plain version")
    check(torch.equal(bits, bits_ref),
          f"{tag}: masked_row_min's bits differ from the plain packing")
    check(torch.equal(bits, sel.bits),
          f"{tag}: the selection's bits differ from masked_row_min's")
    pass_args = (C, bits, rowmin)
    fused = m <= cuda_sparse.FUSED_MAX_COLS

    # Flat integrand (eps = 1e30 makes every in-mask exp exactly 1.0f): the
    # products count candidates, and must match as exact integers. The
    # fused step's row mass is the row counts, so u = 1 and its column
    # product counts too.
    ones_m = torch.ones(m, device=C.device)
    ones_n = torch.ones(n, device=C.device)
    rc_ref = cuda_sparse.masked_row_matvec_ref(*pass_args, ones_m, eps=1e30)
    cc_ref = cuda_sparse.masked_col_matvec_ref(*pass_args, ones_n, eps=1e30)
    check(torch.equal(
        cuda_sparse.masked_row_matvec(*pass_args, ones_m, eps=1e30), rc_ref),
        f"{tag}: row candidate counts differ")
    check(torch.equal(
        cuda_sparse.masked_col_matvec(*pass_args, ones_n, eps=1e30), cc_ref),
        f"{tag}: column candidate counts differ")
    if fused:
        r, c = cuda_sparse.masked_sinkhorn_step(
            *pass_args, ones_m, rc_ref, eps=1e30)
        check(torch.equal(r, rc_ref) and torch.equal(c, cc_ref),
              f"{tag}: fused candidate counts differ")
    check(int(rc_ref.min().item()) >= SPARSE_K,
          f"{tag}: a row has fewer than K candidates")

    gen = torch.Generator(device=C.device).manual_seed(SEED + 3)
    v = torch.rand(m, generator=gen, device=C.device) + 0.1
    u = torch.rand(n, generator=gen, device=C.device) + 0.1
    row_mass = torch.rand(n, generator=gen, device=C.device) * 8 + 1
    eps = dict(eps=SPARSE_EPS)
    ops = {
        "masked_row_matvec": (
            functools.partial(cuda_sparse.masked_row_matvec, *pass_args, v,
                              **eps),
            functools.partial(cuda_sparse.masked_row_matvec_ref, *pass_args,
                              v, **eps)),
        "masked_col_matvec": (
            functools.partial(cuda_sparse.masked_col_matvec, *pass_args, u,
                              **eps),
            functools.partial(cuda_sparse.masked_col_matvec_ref, *pass_args,
                              u, **eps)),
    }
    if fused:
        ops["masked_sinkhorn_step"] = (
            functools.partial(cuda_sparse.masked_sinkhorn_step, *pass_args,
                              v, row_mass, **eps),
            functools.partial(cuda_sparse.masked_sinkhorn_step_ref,
                              *pass_args, v, row_mass, **eps))

    def flat(out):  # the fused step's (r, c) as one vector
        return torch.cat(out) if isinstance(out, tuple) else out

    errors = {"select_candidates": 0.0, "masked_row_min": 0.0}
    for name, (kernel, plain) in ops.items():
        got, ref = flat(kernel()), flat(plain())
        errors[name] = float((got - ref).abs().max().item())
        check(torch.allclose(got, ref, **SPARSE_TOL),
              f"{tag}: {name} differs from its plain version "
              f"(max abs {errors[name]})")
    return {"args": args, "kw": kw, "x_row": x_row, "pass_args": pass_args,
            "v": v, "row_mass": row_mass, "ops": ops,
            "candidates": int(rc_ref.sum().item()), "errors": errors,
            "exact_share": float(exact.sum().item()) / (n * m),
            "exact_max_per_row": int(exact.max().item())}


def phase_kernels(dev, card: str) -> dict:
    n, m = TIER
    gen = torch.Generator(device=dev).manual_seed(SEED)
    C = (torch.randn((n, m), generator=gen, device=dev) * 3.0).to(
        torch.bfloat16
    )
    wide_odd = (torch.randn((WIDE[0], WIDE[1] + 1), generator=gen,
                            device=dev) * 3.0).to(torch.bfloat16)
    # The guard band's bound on the fast draw, over every uniform.
    draw_err, draw_bound = cuda_sparse.gumbel_err(dev)
    check(math.isfinite(draw_err) and draw_err <= draw_bound,
          f"the fast Gumbel draw is {draw_err} from the exact one, over the "
          f"band's bound {draw_bound}")
    # The unvectorized paths first: odd widths (no 16-byte loads, no ring
    # stage, a ballot per mask word; one and two column slabs) and ragged
    # last words and blocks.
    cases = {
        "ragged": check_sparse_kernels(
            C[:RAGGED[0], :RAGGED[1]].contiguous(), "ragged"),
        "wide_odd": check_sparse_kernels(
            wide_odd[:RAGGED[0]].contiguous(), "wide_odd"),
    }
    # Rows with more than 32 candidates (the column kernels' later rounds,
    # the selection's hundreds of exact keys), in one column slab and in
    # two: costs in {0, 1, 2} and no selection noise, so the K-th key ties
    # with a third of the row.
    ties = torch.randint(0, 3, (TIES_ROWS, WIDE[1]), generator=gen,
                         device=dev).to(torch.bfloat16)
    cases["ties"] = check_sparse_kernels(ties[:, :m].contiguous(), "ties",
                                         seed=None)
    cases["ties_wide"] = check_sparse_kernels(ties, "ties_wide", seed=None)
    del ties
    # The wide path's shape: the column-only pass's second slab.
    w = cases["wide"] = check_sparse_kernels(
        wide_odd[:, :WIDE[1]].contiguous(), "wide")
    del wide_odd
    t = cases["tier"] = check_sparse_kernels(C, "tier")
    args, kw, pass_args = t["args"], t["kw"], t["pass_args"]
    x_row = t["x_row"]

    def unfused_route():
        """What the selection replaces: the PyTorch-op key, the stable
        top-K, the K-th key, then the mask-only kernel."""
        key = cuda_sparse.selection_key(C, x_row, **kw)
        neg_vals, _ = auction.top_k(-key, SPARSE_K)
        cuda_sparse.masked_row_min(C, -neg_vals.amin(dim=1), x_row, **kw)

    def row_then_col():
        """The unfused iteration: row product, clamp, divide, column."""
        r = torch.clamp_min(cuda_sparse.masked_row_matvec(
            *pass_args, t["v"], eps=SPARSE_EPS), cuda_sparse.TINY)
        cuda_sparse.masked_col_matvec(*pass_args, t["row_mass"] / r,
                                      eps=SPARSE_EPS)

    def nbytes(name, shape):
        """Bytes the function must move: its inputs once, its outputs
        once."""
        rows, cols = shape
        c_bytes = rows * cols * 2
        bits_bytes = rows * cuda_sparse.mask_words(cols) * 4
        return {
            "select_candidates": c_bytes + 3 * rows * 4 + bits_bytes
            + rows * SPARSE_K * 8,
            "masked_row_min": c_bytes + 3 * rows * 4 + bits_bytes,
            "masked_row_matvec": c_bytes + bits_bytes + 2 * rows * 4
            + cols * 4,
            "masked_col_matvec": c_bytes + bits_bytes + 2 * rows * 4
            + cols * 4,
            "masked_sinkhorn_step": c_bytes + bits_bytes + 3 * rows * 4
            + 2 * cols * 4,
        }[name]

    calls = {
        "select_candidates": (
            lambda: cuda_sparse.select_candidates(C, x_row, SPARSE_K, **kw),
            lambda: cuda_sparse.select_candidates_ref(C, x_row, SPARSE_K,
                                                      **kw)),
        "masked_row_min": (
            lambda: cuda_sparse.masked_row_min(*args, **kw),
            lambda: cuda_sparse.masked_row_min_ref(*args, **kw)),
    }
    calls.update(t["ops"])
    # Each kernel at the shape its path gives it: the column-only pass runs
    # on the wide path alone (the tier takes the fused step).
    at = {name: (TIER, calls[name], t) for name in calls}
    at["masked_col_matvec"] = (WIDE, w["ops"]["masked_col_matvec"], w)
    results = {}
    for name, (shape, (kernel, plain), case) in at.items():
        results[name] = {
            "shape": list(shape), "max_abs_err": case["errors"][name],
            "ms": time_ms(kernel, KERNEL_REPS),
            "plain_ms": time_ms(plain, 5), "library_ms": None,
            **bound(name, nbytes(name, shape), shape[0] * shape[1], card,
                    case["candidates"]),
        }
    # The row-only and column-only passes at the other path's shape too.
    results["masked_row_matvec"]["wide_ms"] = time_ms(
        w["ops"]["masked_row_matvec"][0], KERNEL_REPS)
    results["masked_col_matvec"]["tier_ms"] = time_ms(
        calls["masked_col_matvec"][0], KERNEL_REPS)
    results["masked_sinkhorn_step"]["row_then_col_ms"] = time_ms(
        row_then_col, KERNEL_REPS)
    results["select_candidates"]["unfused_route_ms"] = time_ms(
        unfused_route, 5)
    results["select_candidates"]["kernel_split_ms"] = kernel_split_ms(
        calls["select_candidates"][0], KERNEL_REPS)
    results["select_candidates"]["unfused_route_split_ms"] = kernel_split_ms(
        unfused_route, 5)
    # The pass and its combine of block partials, apart, at the tier.
    for name in ("masked_col_matvec", "masked_sinkhorn_step"):
        results[name]["tier_kernel_split_ms"] = kernel_split_ms(
            calls[name][0], KERNEL_REPS)
    emit({"phase": "kernels", "card": card,
          "shapes_checked": {"tier": [n, m], "wide": list(WIDE),
                             "ragged": list(RAGGED),
                             "wide_odd": [RAGGED[0], WIDE[1] + 1],
                             "ties": [TIES_ROWS, m],
                             "ties_wide": [TIES_ROWS, WIDE[1]]},
          "counting_exact": True, "candidates": t["candidates"],
          "wide_candidates": w["candidates"],
          "draw_err": draw_err, "draw_bound": draw_bound,
          "select_exact_share": {tag: c["exact_share"]
                                 for tag, c in cases.items()},
          "select_exact_max_per_row": {tag: c["exact_max_per_row"]
                                       for tag, c in cases.items()},
          **results})
    del C, t, w, cases, calls, at, pass_args, args, x_row
    torch.cuda.empty_cache()
    return results


def load_operands(gen, n: int, slots: int, m: int, integer: bool = True):
    """An assignment as the auctions give one: ids in [0, m), 80% of the
    slots valid, sizes as the synthetic fleet's (integers 16-255) or
    uniform f32 in [0, 256)."""
    dev = gen.device
    idx = torch.randint(0, m, (n, slots), generator=gen, device=dev)
    valid = torch.rand((n, slots), generator=gen, device=dev) < 0.8
    if integer:
        sizes = torch.randint(16, 256, (n,), generator=gen,
                              device=dev).to(torch.float32)
    else:
        sizes = torch.rand(n, generator=gen, device=dev) * 256
    return idx, valid, sizes


def phase_load_kernel(dev, card: str) -> dict:
    """The implied-load kernel against its plain version (the one-hot
    compare-reduce) at the auctions' shapes: bitwise at integer sizes
    (every sum exact), within LOAD_TOL at f32 sizes; two launches on one
    input bitwise; timed beside its bound and index_add_."""
    cuda_load = load_ops()
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    n, m = TIER
    checked = {}
    cases = {"tier": (n, MAX_COPIES, m, True),
             "tier_f32": (n, MAX_COPIES, m, False),
             "nsel": (n, MAX_COPIES, m, True),
             "wide": (WIDE[0], MAX_COPIES, WIDE[1], True),
             "ragged": (RAGGED[0], 3, RAGGED[1], True)}
    for tag, (rows, slots, cols, integer) in cases.items():
        idx, valid, sizes = load_operands(gen, rows, slots, cols, integer)
        if tag == "nsel":  # the sparse auction's first 5 slots, as a view
            idx, valid = idx[:, :5], valid[:, :5]
        got = cuda_load.implied_load(idx, valid, sizes, cols)
        again = cuda_load.implied_load(idx, valid, sizes, cols)
        ref = cuda_load.implied_load_ref(idx, valid, sizes, cols)
        err = float((got - ref).abs().max().item())
        checked[tag] = {"shape": [rows, slots], "instances": cols,
                        "max_abs_err": err,
                        "differs_from_plain": bitwise_differs(got, ref)}
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
              f"load {tag}: two launches on one input differ")
        if integer:
            check(torch.equal(got, ref),
                  f"load {tag}: differs from the plain version at integer "
                  f"sizes (max abs {err})")
        else:
            check(torch.allclose(got, ref, **LOAD_TOL),
                  f"load {tag}: differs from the plain version "
                  f"(max abs {err})")
    idx, valid, sizes = load_operands(gen, n, MAX_COPIES, m)
    contrib = (sizes[:, None] * valid.to(torch.float32)).reshape(-1)
    flat = idx.reshape(-1)
    nbytes = idx.numel() * 9 + n * 4 + m * 4
    result = {
        "shape": [n, MAX_COPIES], "instances": m,
        "max_abs_err": checked["tier"]["max_abs_err"],
        "ms": time_ms(lambda: cuda_load.implied_load(idx, valid, sizes, m),
                      KERNEL_REPS),
        "plain_ms": time_ms(
            lambda: cuda_load.implied_load_ref(idx, valid, sizes, m), 5),
        # index_add_ of the weights (built outside the timing).
        "library_ms": time_ms(
            lambda: torch.zeros(m, device=dev).index_add_(0, flat, contrib),
            KERNEL_REPS),
        "kernel_split_ms": kernel_split_ms(
            lambda: cuda_load.implied_load(idx, valid, sizes, m),
            KERNEL_REPS),
        **bound("implied_load", nbytes, idx.numel(), card),
    }
    emit({"phase": "load_kernel", "card": card, "checked": checked,
          "implied_load": result})
    return {"implied_load": result}


def lse_operands(shape, gen, scale: float = 1.0) -> dict:
    """C ~ 3 N(0, 1) in bf16, g, f ~ N(0, 1) and log_a of masses in
    [1, 9), from ``gen``; C and the shifts times ``scale``."""
    n, m = shape
    dev = gen.device
    C = (torch.randn((n, m), generator=gen, device=dev) * (3.0 * scale)).to(
        torch.bfloat16)
    return {"C": C,
            "g": torch.randn(m, generator=gen, device=dev) * scale,
            "f": torch.randn(n, generator=gen, device=dev) * scale,
            "log_a": torch.log(torch.rand(n, generator=gen, device=dev) * 8
                               + 1)}


def lse_calls(op: dict) -> dict:
    """name -> (kernel call, plain call) of every LSE wrapper that takes
    C's width; each returns a tuple of tensors."""
    C, g, f, log_a = op["C"], op["g"], op["f"], op["log_a"]
    calls = {
        "row_lse_partial": (
            lambda: cuda_lse.row_lse_partial(C, g, LSE_EPS),
            lambda: cuda_lse.row_lse_partial_ref(C, g, LSE_EPS)),
        "col_lse_partial": (
            lambda: cuda_lse.col_lse_partial(C, f, LSE_EPS),
            lambda: cuda_lse.col_lse_partial_ref(C, f, LSE_EPS)),
    }
    if C.shape[1] <= cuda_lse.FUSED_MAX_COLS:
        calls["lse_sinkhorn_step"] = (
            lambda: cuda_lse.lse_sinkhorn_step(C, g, log_a, LSE_EPS),
            lambda: cuda_lse.lse_sinkhorn_step_ref(C, g, log_a, LSE_EPS))
    return calls


def max_abs(a, b) -> float:
    return float((a - b).abs().max().item())


def check_lse_kernels(op: dict, tag: str, tol: dict = LSE_TOL) -> dict:
    """Every LSE kernel that takes C's width against its plain version:
    the LSE and the running max within ``tol``, the fused step's f too.
    On the card the kernels' z is the plain z bit for bit, so the running
    maxima are compared bitwise as well (counted), and the fused step
    against the row and column kernels run back to back on the same
    operands (bitwise, counted). Returns the errors by kernel."""
    errors, bitwise = {}, {}
    out = {}
    for name, (kernel, plain) in lse_calls(op).items():
        got, ref = kernel(), plain()
        out[name] = got
        *lead, km, ks = got
        *_, pm, ps = ref
        lse, lse_ref = cuda_lse.lse_of(km, ks), cuda_lse.lse_of(pm, ps)
        errors[name] = max_abs(lse, lse_ref)
        check(bool(torch.isfinite(lse).all()), f"{tag}: {name} not finite")
        check(torch.allclose(lse, lse_ref, **tol),
              f"{tag}: {name}'s LSE differs from the plain version "
              f"(max abs {errors[name]})")
        check(torch.allclose(km, pm, **tol),
              f"{tag}: {name}'s running max differs "
              f"(max abs {max_abs(km, pm)})")
        bitwise[f"{name}_max_differs"] = int((km != pm).sum().item())
        if lead:
            err_f = max_abs(lead[0], ref[0])
            errors[name] = max(errors[name], err_f)
            check(torch.allclose(lead[0], ref[0], **tol),
                  f"{tag}: {name}'s f differs (max abs {err_f})")
    if "lse_sinkhorn_step" in out:
        # The unfused iteration on the kernels: row, f, column.
        f, cm, cs = out["lse_sinkhorn_step"]
        f_pair = LSE_EPS * (op["log_a"]
                            - cuda_lse.lse_of(*out["row_lse_partial"]))
        pm, ps = cuda_lse.col_lse_partial(op["C"], f, LSE_EPS)
        bitwise["step_f_vs_row_kernel_differs"] = int(
            (f != f_pair).sum().item())
        bitwise["step_col_vs_col_kernel_differs"] = int(
            ((cm != pm) | (cs != ps)).sum().item())
    return {"errors": errors, "bitwise": bitwise}


def check_z_bitwise(op: dict, tag: str) -> None:
    """z of one row, bit for bit: over a single row the column kernel's
    running max is z itself (and its rescaled sum 1)."""
    C1, f1 = op["C"][:1].contiguous(), op["f"][:1].contiguous()
    m1, s1 = cuda_lse.col_lse_partial(C1, f1, LSE_EPS)
    z = ((f1[:, None] - C1.to(torch.float32)) / LSE_EPS)[0]
    check(torch.equal(m1.view(torch.int32), z.view(torch.int32)),
          f"{tag}: the kernel's z of row 0 differs bitwise from the plain "
          f"z ({int((m1 != z).sum().item())} of {z.numel()} columns)")
    check(bool((s1 == 1.0).all()), f"{tag}: single-row sums differ from 1")


def lse_nbytes(name: str, shape) -> int:
    """Bytes the function must move: its inputs once, its outputs once."""
    n, m = shape
    return n * m * 2 + {
        "row_lse_partial": m * 4 + 2 * n * 4,
        "col_lse_partial": n * 4 + 2 * m * 4,
        "lse_sinkhorn_step": m * 4 + n * 4 + n * 4 + 2 * m * 4,
    }[name]


def lse_library(op: dict, name: str):
    """One PyTorch call for the same function, timed: torch.logsumexp
    over a materialized f32 z (the row or column kernel); the fused step
    has none. Returns (ms, ms to build z) or (None, None)."""
    if name == "lse_sinkhorn_step":
        return None, None
    C = op["C"]
    row = name == "row_lse_partial"
    shift = op["g"][None, :] if row else op["f"][:, None]
    torch.cuda.synchronize()
    t = time.perf_counter()
    z = (shift - C.to(torch.float32)) / LSE_EPS
    torch.cuda.synchronize()
    z_ms = (time.perf_counter() - t) * 1e3
    ms = time_ms(lambda: torch.logsumexp(z, dim=1 if row else 0),
                 KERNEL_REPS)
    del z
    return ms, z_ms


def phase_lse_kernels(dev, card: str) -> dict:
    """Kernels 4-5 and the fused step against their plain versions at every
    width their paths give them, timed at the tier, at the dense tier's
    real width and (the column-only kernel) at the wide path's shape."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    checked, bitwise, timed = {}, {}, {}
    for tag, shape in LSE_SHAPES.items():
        op = lse_operands(shape, gen)
        check_z_bitwise(op, tag)
        case = check_lse_kernels(op, tag)
        checked[tag] = {"shape": list(shape), "max_abs_err": case["errors"]}
        bitwise[tag] = case["bitwise"]
        if tag in LSE_TIMED:
            timed[tag] = lse_times(op, case["errors"], card)
        if tag == "tier":
            # Extreme values: |z| of order 1e3 and more.
            x = lse_operands(shape, gen, scale=30.0)
            xcase = check_lse_kernels(x, "extreme",
                                      dict(rtol=1e-5, atol=0.0))
            checked["extreme"] = {"shape": list(shape), "scale": 30.0,
                                  "max_abs_err": xcase["errors"]}
            del x
        del op
        torch.cuda.empty_cache()
    # Each kernel at the shape its path gives it: the row-only kernel and
    # the fused step at the dense main path's, the column-only kernel at
    # the wide path's (the main path takes the fused step).
    results = {name: dict(timed["tier"][name]) for name in
               ("row_lse_partial", "lse_sinkhorn_step")}
    results["col_lse_partial"] = dict(timed["wide"]["col_lse_partial"])
    for name, entry in results.items():
        for tag, by_name in timed.items():
            if name in by_name:
                entry[f"{tag}_ms"] = by_name[name]["ms"]
                entry[f"{tag}_bound_ms"] = by_name[name]["bound_ms"]
    emit({"phase": "lse_kernels", "eps": LSE_EPS, "card": card,
          "checked": checked, "bitwise": bitwise, "timed": timed})
    return results


def lse_times(op: dict, errors: dict, card: str) -> dict:
    """Per-launch times of the LSE kernels on ``op`` beside their bound,
    plain version and library call; the fused step's pass and combine
    apart (profiler) and the unfused iteration back to back."""
    shape = tuple(op["C"].shape)
    out = {}
    for name, (kernel, plain) in lse_calls(op).items():
        library_ms, z_ms = lse_library(op, name)
        out[name] = {
            "shape": list(shape), "max_abs_err": errors[name],
            "ms": time_ms(kernel, KERNEL_REPS),
            "plain_ms": time_ms(plain, 5),
            "library_ms": library_ms, "library_z_build_ms": z_ms,
            **bound(name, lse_nbytes(name, shape), shape[0] * shape[1], card),
        }
    if "lse_sinkhorn_step" in out:
        C, g, log_a = op["C"], op["g"], op["log_a"]

        def row_then_col():
            """The unfused iteration: row LSE, f, column LSE."""
            f = LSE_EPS * (log_a - cuda_lse.row_lse(C, g, LSE_EPS))
            cuda_lse.col_lse_partial(C, f, LSE_EPS)

        step = out["lse_sinkhorn_step"]
        step["row_then_col_ms"] = time_ms(row_then_col, KERNEL_REPS)
        step["kernel_split_ms"] = kernel_split_ms(lse_calls(op)[
            "lse_sinkhorn_step"][0], KERNEL_REPS)
    return out


def steady_records(n: int, m: int):
    """Synthetic fleet at 85% utilization with seeded rpm (the JAX bench's
    _steady_fleet rule). Returns (models, instances, rpm, rng): the rng
    goes on to draw the churn."""
    models, instances = synthetic_records(n, m)
    demand = sum(mr.size_units for _, mr in models)
    cap = max(1, round(demand / (STEADY_UTILIZATION * m)))
    for _, rec in instances:
        rec.capacity_units = cap
    rng = np.random.default_rng(0)
    rpm = {f"m{i}": int(v) for i, v in enumerate(rng.integers(0, 50, n))}
    return models, instances, rpm, rng


def steady_fleet(n: int, m: int):
    """The snapshot of ``steady_records``' fleet."""
    models, instances, rpm, _ = steady_records(n, m)
    return snapshot_columns(models, instances, rpm)


def demand_of(cols) -> float:
    return float(np.sum(
        cols.sizes * np.minimum(cols.copies, MAX_COPIES), dtype=np.float64
    ))


PLACEMENT_FIELDS = ("indices", "valid", "load", "prices", "f", "g",
                    "overflow")


def same_bytes(a, b) -> bool:
    """a and b hold the same bytes (shape, dtype and every bit)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a = a.detach().reshape(-1).contiguous().view(torch.uint8)
    return torch.equal(a, b.detach().reshape(-1).contiguous().view(
        torch.uint8))


def check_repeatable(dev, cols, cfg, tag: str) -> dict:
    """Two solves of one snapshot with one seed: byte-identical Placements
    (the implied load sums in a fixed order on the card)."""
    sols = [dispatch_solve(cols, seed=42, config=cfg, device=dev).sol
            for _ in range(2)]
    differs = [f for f in PLACEMENT_FIELDS
               if not same_bytes(getattr(sols[0], f), getattr(sols[1], f))]
    check(not differs, f"{tag}: two same-seed solves differ in {differs}")
    return {"fields": list(PLACEMENT_FIELDS), "byte_identical": True}


def load_launches_expected(stats) -> int:
    """Implied loads the auctions run: one per price iteration and one for
    the epilogue's selection (a warm probe that certifies its carry runs
    one iteration and no epilogue)."""
    return sum(st["auction_iters_run"] + (st["auction_iters_run"] > 1)
               for st in stats)


def phase_main(dev, cols, snapshot_s: float) -> dict:
    cuda_load = load_ops()
    cfg = solve_config_from_env()

    def one_solve(seed):
        return finalize_plan(
            dispatch_solve(cols, seed=seed, config=cfg, device=dev)
        )

    one_solve(1_000_000)                     # warm-up
    torch.cuda.synchronize()
    cuda_sparse.reset_launches()
    cuda_load.reset_launches()
    syncs0 = device_mod.host_syncs
    times, stats = [], []
    for rep in range(MAIN_SOLVES):
        t = time.perf_counter()
        plan = one_solve(rep)
        times.append((time.perf_counter() - t) * 1e3)
        stats.append(plan.stats)
    launches = dict(cuda_sparse.launches, **cuda_load.launches)
    syncs = device_mod.host_syncs - syncs0

    demand = demand_of(cols)
    for st in stats:
        check(st["solver_path"] == "sparse", f"path {st['solver_path']}")
        check(st["sparse_impl"] == "cuda", f"impl {st['sparse_impl']}")
        check(math.isfinite(st["overflow"]) and st["overflow"] >= 0,
              "overflow not finite")
        check(math.isfinite(st["row_err"]), "row_err not finite")
    # One selection per solve (it packs the mask; no mask-only pass), one
    # fused pass per Sinkhorn iteration, the row product alone only for the
    # marginal-error gates, no column-only pass at this width, and the
    # fixed-order implied load for every auction selection.
    iters = sum(st["sinkhorn_iters_run"] for st in stats)
    check(launches["select_candidates"] == MAIN_SOLVES
          and launches["masked_row_min"] == 0
          and launches["masked_sinkhorn_step"] == iters
          and launches["masked_col_matvec"] == 0,
          f"sparse launches {launches} for {iters} Sinkhorn iterations")
    check(launches["implied_load"] == load_launches_expected(stats),
          f"implied_load launches {launches['implied_load']} for auction "
          f"iterations {[st['auction_iters_run'] for st in stats]}")
    for name in ("select_candidates", "masked_row_matvec",
                 "masked_sinkhorn_step", "implied_load"):
        check(launches[name] > 0, f"{name} never launched on the main path")
    repeatable = check_repeatable(dev, cols, cfg, "main")
    check(plan.num_models() == MAIN_FLEET[0], "plan lost models")
    inst = set(cols.instance_ids)
    for mid in cols.model_ids[:: MAIN_FLEET[0] // 1000]:
        targets = plan.lookup(mid)
        check(targets is not None and 0 < len(targets) <= MAX_COPIES,
              f"bad targets for {mid}")
        check(set(targets) <= inst, f"unknown instance for {mid}")
    result = {
        "phase": "main", "models": MAIN_FLEET[0],
        "instances": MAIN_FLEET[1], "padded": list(TIER),
        "snapshot_s": snapshot_s, "solves": MAIN_SOLVES,
        "solve_ms_median": float(np.median(times)),
        "solve_ms_max": float(np.max(times)),
        "per_solve_ms": times,
        "device_solve_ms": [st["solve_ms"] for st in stats],
        "extract_ms": [st["extract_ms"] for st in stats],
        "overflow_frac": [st["overflow"] / demand for st in stats],
        "row_err": [st["row_err"] for st in stats],
        "sinkhorn_iters_run": [st["sinkhorn_iters_run"] for st in stats],
        "auction_iters_run": [st["auction_iters_run"] for st in stats],
        "launches": launches,
        "launches_per_solve": {
            k: c / MAIN_SOLVES for k, c in launches.items()
        },
        "host_syncs_per_solve": syncs / MAIN_SOLVES,
        "repeatable": repeatable,
        "topk": stats[-1].get("topk"),
        "solver_path": stats[-1]["solver_path"],
        "sparse_impl": stats[-1]["sparse_impl"],
    }
    emit(result)
    return result


def device_ms_by_kernel(prof) -> dict:
    """name -> [device ms, count] of a torch.profiler run: device-side
    activity only (kernels and copies); the host-side aten:: records would
    count the same work twice."""
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.replace("void ", "").replace(
            "(anonymous namespace)::", "").split("(")[0][:80]
        slot = by_name.setdefault(name, [0.0, 0])
        slot[0] += e.time_range.elapsed_us() / 1e3
        slot[1] += 1
    return by_name


def kernel_split_ms(fn, reps: int) -> dict:
    """Device ms per call of each kernel ``fn`` launches, under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {name: ms / reps
            for name, (ms, _) in device_ms_by_kernel(prof).items()}


def phase_profile(dev, cols, phase: str = "profile", mesh=None) -> None:
    """Where one solve's time goes: torch.profiler over one dispatch +
    finalize (sharded over ``mesh`` when given), device time by kernel
    name and the device's busy share of the solve's wall time."""
    from torch.profiler import ProfilerActivity, profile

    cfg = solve_config_from_env()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        finalize_plan(dispatch_solve(cols, seed=77, config=cfg, mesh=mesh,
                                     device=dev))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = device_ms_by_kernel(prof)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    emit({"phase": phase, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms,
          "top": [{"name": k, "ms": ms, "count": c}
                  for k, (ms, c) in top]})


def phase_parity(dev, fleet=PARITY_FLEET, phase: str = "parity",
                 path: str = "sparse") -> dict:
    """One snapshot solved on the card and on the CPU; returns the card
    solve's kernel launches, sparse, LSE, implied load and threefry
    (counters zeroed just before it)."""
    cuda_load = load_ops()
    _, cuda_random = random_ops()
    cols = steady_fleet(*fleet)
    cfg = solve_config_from_env()
    torch.cuda.synchronize()
    for mod in (cuda_sparse, cuda_lse, cuda_load, cuda_random):
        mod.reset_launches()
    gpu_run = dispatch_solve(cols, seed=5, config=cfg, device=dev)
    launches = dict(cuda_sparse.launches, **cuda_lse.launches,
                    **cuda_load.launches, **cuda_random.launches)
    cpu_run = dispatch_solve(cols, seed=5, config=cfg, device="cpu")
    check(gpu_run.path == cpu_run.path == path,
          f"{phase}: paths {gpu_run.path}/{cpu_run.path}, want {path}")
    check((gpu_run.impl, cpu_run.impl) == ("cuda", "plain"),
          f"{phase}: backends {gpu_run.impl}/{cpu_run.impl}")
    gpu, cpu = gpu_run.sol, cpu_run.sol
    gv, gi = gpu.valid.cpu().numpy(), gpu.indices.cpu().numpy()
    cv, ci = cpu.valid.numpy(), cpu.indices.numpy()
    same = gv == cv
    agree = float(((same & (gi == ci)) | (same & ~cv)).mean())
    demand = demand_of(cols)
    d_over = abs(float(gpu.overflow.item()) - float(cpu.overflow.item()))
    emit({"phase": phase, "models": fleet[0], "instances": fleet[1],
          "padded": list(gpu_run.sol.indices.shape[:1])
          + list(gpu_run.sol.load.shape),
          "solver_path": path, "agreement": agree,
          "overflow_gpu": float(gpu.overflow.item()),
          "overflow_cpu": float(cpu.overflow.item()),
          "overflow_diff_frac": d_over / demand,
          "sinkhorn_iters_run": gpu.sinkhorn_iters_run,
          "launches": launches})
    check(agree >= 0.97, f"{phase}: GPU/CPU placement agreement {agree}")
    check(d_over <= 0.005 * demand, f"{phase}: overflow differs by {d_over}")
    return {"launches": launches, "sinkhorn_iters_run": gpu.sinkhorn_iters_run}


def phase_wide(dev) -> dict:
    """The sparse path wider than the fused step: parity, and the row and
    column products back to back on every Sinkhorn iteration."""
    run = phase_parity(dev, WIDE_FLEET, "wide")
    got, iters = run["launches"], run["sinkhorn_iters_run"]
    check(got["masked_sinkhorn_step"] == 0,
          f"wide: the fused step ran at a width above its limit: {got}")
    check(got["masked_col_matvec"] == iters and got["select_candidates"] == 1
          and got["masked_row_min"] == 0,
          f"wide: launches {got} for {iters} Sinkhorn iterations")
    return got


def phase_dense_wide(dev) -> dict:
    """The dense tier wider than the fused LSE step: the wide fleet pinned
    dense (12288 x 1536), parity, and the row and column LSE back to back
    on every Sinkhorn iteration: the column-only kernel's path."""
    with dense_pin():
        run = phase_parity(dev, WIDE_FLEET, "dense_wide", "dense")
    got, iters = run["launches"], run["sinkhorn_iters_run"]
    check(got["lse_sinkhorn_step"] == 0,
          f"dense_wide: the fused step ran at a width above its limit: {got}")
    # Each iteration a row and a column pass, and the row pass of the
    # final marginal error.
    check(got["col_lse_partial"] == iters
          and got["row_lse_partial"] == iters + 1,
          f"dense_wide: launches {got} for {iters} Sinkhorn iterations")
    for name in ("row_lse_partial", "col_lse_partial"):
        check(got[name] > 0, f"{name} never launched on the dense_wide path")
    return got


@contextlib.contextmanager
def env_pin(name: str, value: str):
    """The environment variable ``name`` set to ``value`` for the duration,
    restored after (bench.py's run_path pin)."""
    prev = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


def dense_pin():
    """MM_SOLVER_SPARSE=0 for the duration."""
    return env_pin("MM_SOLVER_SPARSE", "0")


def packed_key_top_k(x, k: int):
    """The other tie-stable top-k: torch.topk over an int64 key that packs
    the value's order-preserving bits above the reversed column index (no
    two keys tie). Timed here as the alternative to the port's stable
    sort; the port does not use it."""
    bits = x.contiguous().view(torch.int32)
    key = torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits).to(torch.int64)
    rev = torch.arange(x.shape[1] - 1, -1, -1, device=x.device)
    key.mul_(1 << 32).add_(rev)
    idx = torch.topk(key, k, dim=1).indices
    return torch.gather(x, 1, idx), idx


def time_top_k(dev) -> dict:
    """The auction's tie-stable top-k (a stable descending sort, cut) at
    its shortlist shape against the packed-key top-k and torch.topk
    (fast, but in no fixed tie order), on bf16-rounded scores (many
    ties)."""
    n, m = TIER
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = (torch.randn((n, m), generator=gen, device=dev) * 4.0).to(
        torch.bfloat16).to(torch.float32)
    _, idx = auction.top_k(x, K_CAND)
    check(torch.equal(idx, packed_key_top_k(x, K_CAND)[1]),
          "top_k differs from the packed-key top-k")
    out = {
        "shape": [n, m], "k": K_CAND,
        "stable_sort_top_k_ms": time_ms(lambda: auction.top_k(x, K_CAND), 5),
        "packed_key_topk_ms": time_ms(lambda: packed_key_top_k(x, K_CAND), 5),
        "torch_topk_ms": time_ms(lambda: torch.topk(x, K_CAND, dim=1), 5),
    }
    del x
    torch.cuda.empty_cache()
    return out


def phase_dense_main(dev, cols) -> dict:
    cuda_load = load_ops()
    cfg = solve_config_from_env()

    def one_solve(seed, config=cfg):
        return finalize_plan(
            dispatch_solve(cols, seed=seed, config=config, device=dev)
        )

    one_solve(2_000_000)                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_lse.reset_launches()
    cuda_sparse.reset_launches()
    cuda_load.reset_launches()
    syncs0 = device_mod.host_syncs
    times, stats = [], []
    for rep in range(MAIN_SOLVES):
        t = time.perf_counter()
        plan = one_solve(100 + rep)
        times.append((time.perf_counter() - t) * 1e3)
        stats.append(plan.stats)
    launches = dict(cuda_lse.launches, **cuda_load.launches)
    sparse_launches = dict(cuda_sparse.launches)
    syncs = device_mod.host_syncs - syncs0
    peak_bytes = torch.cuda.max_memory_allocated(dev)

    demand = demand_of(cols)
    for st in stats:
        check(st["solver_path"] == "dense", f"path {st['solver_path']}")
        check(st["lse_impl"] == "cuda", f"lse_impl {st.get('lse_impl')}")
        check(math.isfinite(st["overflow"]) and st["overflow"] >= 0,
              "overflow not finite")
        check(math.isfinite(st["row_err"]), "row_err not finite")
    # Fixed budget: one fused step per iteration, the row LSE of the final
    # marginal error, no column-only pass at this width; and one host sync,
    # the readback.
    iters = cfg.sinkhorn_iters
    want = {"lse_sinkhorn_step": iters, "row_lse_partial": 1,
            "col_lse_partial": 0}
    per_solve = {k: c / MAIN_SOLVES for k, c in launches.items()}
    if cfg.sinkhorn_tol <= 0:
        check({k: per_solve[k] for k in want} == want,
              f"LSE launches per solve {per_solve}")
        if cfg.auction_stall_tol <= 0:
            check(syncs == MAIN_SOLVES,
                  f"{syncs / MAIN_SOLVES} host syncs per dense solve")
    check(launches["implied_load"] == load_launches_expected(stats),
          f"implied_load launches {launches['implied_load']} for auction "
          f"iterations {[st['auction_iters_run'] for st in stats]}")
    for name in ("lse_sinkhorn_step", "row_lse_partial", "implied_load"):
        check(launches[name] > 0, f"{name} never launched on the dense path")
    check(all(c == 0 for c in sparse_launches.values()),
          f"sparse kernels ran on the dense path: {sparse_launches}")
    check(plan.num_models() == MAIN_FLEET[0], "plan lost models")
    inst = set(cols.instance_ids)
    for mid in cols.model_ids[:: MAIN_FLEET[0] // 1000]:
        targets = plan.lookup(mid)
        check(targets is not None and 0 < len(targets) <= MAX_COPIES,
              f"bad targets for {mid}")
        check(set(targets) <= inst, f"unknown instance for {mid}")

    # The steady gates (bench.py's _steady_solve_config): the probe and
    # chunk branches of both stages on the card.
    gated_cfg = cfg._replace(sinkhorn_tol=0.02, auction_stall_tol=1e-3)
    syncs0 = device_mod.host_syncs
    t = time.perf_counter()
    gated = one_solve(7, gated_cfg).stats
    gated_ms = (time.perf_counter() - t) * 1e3
    check(gated["solver_path"] == "dense" and math.isfinite(gated["overflow"]),
          "gated dense solve")
    repeatable = check_repeatable(dev, cols, cfg, "dense_main")
    result = {
        "phase": "dense_main", "models": MAIN_FLEET[0],
        "instances": MAIN_FLEET[1], "padded": list(TIER),
        "pin": "MM_SOLVER_SPARSE=0", "solves": MAIN_SOLVES,
        "solve_ms_median": float(np.median(times)),
        "solve_ms_max": float(np.max(times)),
        "per_solve_ms": times,
        "device_solve_ms": [st["solve_ms"] for st in stats],
        "extract_ms": [st["extract_ms"] for st in stats],
        "overflow_frac": [st["overflow"] / demand for st in stats],
        "row_err": [st["row_err"] for st in stats],
        "sinkhorn_iters_run": [st["sinkhorn_iters_run"] for st in stats],
        "auction_iters_run": [st["auction_iters_run"] for st in stats],
        "launches": launches,
        "launches_per_solve": per_solve,
        "host_syncs_per_solve": syncs / MAIN_SOLVES,
        "peak_device_bytes": peak_bytes,
        "repeatable": repeatable,
        "solver_path": stats[-1]["solver_path"],
        "lse_impl": stats[-1]["lse_impl"],
        "gated": {
            "solve_ms": gated_ms,
            "device_solve_ms": gated["solve_ms"],
            "overflow_frac": gated["overflow"] / demand,
            "row_err": gated["row_err"],
            "sinkhorn_iters_run": gated["sinkhorn_iters_run"],
            "auction_iters_run": gated["auction_iters_run"],
            "host_syncs": device_mod.host_syncs - syncs0,
        },
        "top_k": time_top_k(dev),
    }
    emit(result)
    return result


def steady_solve_config():
    """bench.py's _steady_solve_config: the steady gates
    (sinkhorn_tol 0.02, auction_stall_tol 1e-3) unless the operator pinned
    them."""
    cfg = solve_config_from_env()
    if not os.environ.get("MM_SOLVER_SINKHORN_TOL"):
        cfg = cfg._replace(sinkhorn_tol=0.02)
    if not os.environ.get("MM_SOLVER_AUCTION_STALL_TOL"):
        cfg = cfg._replace(auction_stall_tol=1e-3)
    return cfg


def new_strategy(dev, frac: float) -> TorchPlacementStrategy:
    # The default fallback: the port's GreedyStrategy (refresh never asks
    # it, so the phases' counts and placements are as they were).
    strat = TorchPlacementStrategy(solve_config=steady_solve_config(),
                                   device=dev)
    strat.incr_max_dirty_frac = frac
    return strat


def churn(fleet) -> list:
    """bench.py's churn: ~1% of models (n // 100, drawn from the fleet's
    rng) get last_used = now and a fresh rpm in 0-49; model-only."""
    models, _, rpm, rng = fleet
    n = len(models)
    dirty = []
    now = now_ms()
    for i in rng.integers(0, n, max(1, n // 100)):
        mid, mr = models[int(i)]
        mr.last_used = now
        rpm[mid] = int(rng.integers(0, 50))
        dirty.append(mid)
    return dirty


def all_launches() -> dict:
    return dict(load_ops().launches, **cuda_sparse.launches,
                **cuda_lse.launches)


def reset_all_launches() -> None:
    for mod in (load_ops(), cuda_sparse, cuda_lse):
        mod.reset_launches()


def steady_cycle(strat, fleet, dev, dirty=None) -> dict:
    """One churn cycle: mark the churned models (``dirty``, or a fresh
    ``churn``) dirty, refresh incrementally; the launch counters zeroed
    just before the refresh and read just after."""
    models, instances, rpm, _ = fleet
    strat.mark_dirty(churn(fleet) if dirty is None else dirty, [])
    torch.cuda.synchronize(dev)
    reset_all_launches()
    syncs0 = device_mod.host_syncs
    t = time.perf_counter()
    plan = strat.refresh(models, instances, rpm, incremental=True)
    wall_ms = (time.perf_counter() - t) * 1e3
    return {"stats": dict(plan.stats), "wall_ms": wall_ms,
            "launches": all_launches(),
            "host_syncs": device_mod.host_syncs - syncs0,
            "base_overflow": strat._base.overflow, "plan": plan}


def summary(values) -> dict:
    return {"median": float(np.median(values)), "max": float(np.max(values)),
            "all": [float(v) for v in values]}


SPARSE_NAMES = ("select_candidates", "masked_row_min", "masked_row_matvec",
                "masked_col_matvec", "masked_sinkhorn_step")


def steady_run(dev, fleet, frac: float, tag: str, demand: float) -> dict:
    """A cold refresh and STEADY_CYCLES churn cycles through one strategy
    (after a throwaway refresh), under the sparse pin. With ``frac`` > 0
    the incremental cycles are checked: one host sync, the drift budget,
    the row LSE and the implied load once each and nothing else."""
    models, instances, rpm, _ = fleet
    with env_pin("MM_SOLVER_SPARSE", "1"):
        new_strategy(dev, frac).refresh(models, instances, rpm)
        strat = new_strategy(dev, frac)
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        cold = strat.refresh(models, instances, rpm)
        cold_ms = (time.perf_counter() - t) * 1e3
        cycles = [steady_cycle(strat, fleet, dev)
                  for _ in range(STEADY_CYCLES)]
    paths = [c["stats"]["solver_path"] for c in cycles]
    incr = [c for c in cycles if c["stats"]["solver_path"] == "incremental"]
    counted = incr if frac > 0 else cycles
    for c in counted:
        st = c["stats"]
        check(math.isfinite(st["overflow"]) and st["overflow"] >= 0,
              f"{tag}: overflow not finite")
    for c in incr:
        st, got = c["stats"], c["launches"]
        check(st["lse_impl"] == "cuda", f"{tag}: lse_impl {st['lse_impl']}")
        check(c["host_syncs"] == 1 and st["host_syncs"] == 1,
              f"{tag}: {c['host_syncs']} host syncs in an incremental "
              "refresh")
        check(st["overflow"] <= c["base_overflow"] + 0.005 * demand,
              f"{tag}: merged overflow {st['overflow']} past the base's "
              f"{c['base_overflow']} + 0.5% of demand")
        want = dict.fromkeys(got, 0)
        want.update(row_lse_partial=1, implied_load=1)
        check(got == want, f"{tag}: launches in an incremental refresh "
              f"{got}, want {want}")
    if frac <= 0:
        for c in cycles:
            check(c["stats"]["solver_path"] == "sparse"
                  and c["stats"]["sparse_impl"] == "cuda",
                  f"{tag}: full warm cycle took {c['stats']['solver_path']}")
    out = {
        "cycles": len(cycles), "paths": paths,
        "incremental_cycles": len(incr),
        "fallback_cycles": len(cycles) - len(incr) if frac > 0 else 0,
        "cold_ms": cold_ms, "cold_solve_ms": cold.stats["solve_ms"],
        "dirty_rows": [c["stats"].get("dirty_rows") for c in cycles],
        "host_syncs": [c["host_syncs"] for c in cycles],
        "overflow_frac": [c["stats"]["overflow"] / demand for c in cycles],
        "base_overflow_frac": [c["base_overflow"] / demand for c in cycles],
        "launches": [c["launches"] for c in cycles],
        "warm": [c["stats"]["warm"] for c in cycles],
    }
    for key in ("solve_ms", "snapshot_ms", "extract_ms"):
        out[key] = summary([c["stats"][key] for c in counted])
    out["wall_ms"] = summary([c["wall_ms"] for c in counted])
    if incr:
        out["launches_per_incremental_refresh"] = incr[-1]["launches"]
    return {"summary": out, "strategy": strat}


def steady_stages(dev, strat, fleet) -> dict:
    """Where an incremental refresh's time goes: one more churn cycle's
    refresh staged by hand, each stage ended by a device sync (the patch,
    the device expansion, the full-width ``sizes @ loaded`` of the cost
    rows, the rest of the cost rows, the re-solve, the readback and the
    extraction), then the same refresh again under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from modelmesh_tpu_torch.ops import costs
    from modelmesh_tpu_torch.ops.solve import solve_placement_incremental
    from modelmesh_tpu_torch.placement import torch_engine as te

    models, instances, rpm, _ = fleet
    dirty = churn(fleet)
    cfg = steady_solve_config()
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        stages[name] = (time.perf_counter() - t) * 1e3
        return out

    with env_pin("MM_SOLVER_SPARSE", "1"):
        cache = strat._snap_cache
        cols = stage("patch_ms", lambda: te.patch_columns(
            cache, models, instances, rpm, set(dirty), set()))
        check(cols is not None, "steady: the delta patch fell back")
        # The part of the patch that reads every record: rpm re-read.
        stage("patch_rpm_reread_ms", lambda: te._rpm_column(
            rpm, cols.model_ids, len(cols.model_ids)))
        rows = sorted(cache.model_pos[mid] for mid in dirty)
        base = strat._base
        n_pad = base.indices.shape[0]
        padded = np.full(te._bucket(len(rows), 64), n_pad, np.int64)
        padded[: len(rows)] = rows
        problem = stage("expand_ms",
                        lambda: te._expand_problem_device(cols, dev))
        d_rows = torch.from_numpy(np.minimum(padded, n_pad - 1)).to(dev)
        stage("loaded_mass_ms",
              lambda: problem.sizes @ problem.loaded.to(torch.float32))
        stage("cost_rows_ms", lambda: costs.assemble_cost_rows(
            problem, d_rows, dtype=cfg.dtype))
        sol = stage("resolve_ms", lambda: solve_placement_incremental(
            problem, cfg, strat._seed, torch.from_numpy(padded).to(dev),
            base.indices, base.valid, base.g, base.prices, base.row_err))
        pending = te.PendingSolve(cols=cols, sol=sol,
                                  t_start=time.perf_counter(),
                                  t_snapshot=time.perf_counter(), warm=True,
                                  path="incremental", dirty_rows=len(rows))
        plan = stage("finalize_ms", lambda: te.finalize_plan(pending))
        stages["readback_and_pack_ms"] = plan.stats["solve_ms"]
        stages["extract_ms"] = plan.stats["extract_ms"]
        stages["dirty_rows"] = len(rows)
        # The whole refresh through the strategy, profiled.
        strat.mark_dirty(dirty, [])
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            prof_plan = strat.refresh(models, instances, rpm,
                                      incremental=True)
            torch.cuda.synchronize(dev)
            wall_ms = (time.perf_counter() - t) * 1e3
    by_name = device_ms_by_kernel(prof)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return {"stages": stages,
            "profile": {"solver_path": prof_plan.stats["solver_path"],
                        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                        "device_idle_share": 1.0 - busy_ms / wall_ms,
                        "top": [{"name": k, "ms": ms, "count": c}
                                for k, (ms, c) in top]}}


def check_incremental_repeatable(dev, strat, fleet) -> dict:
    """Two ``dispatch_solve(cols, seed, base=, dirty_rows=)`` calls on one
    base: byte-identical indices, valid, load and overflow."""
    cache, base = strat._snap_cache, strat._base
    models = fleet[0]
    rows = sorted(cache.model_pos[models[i][0]]
                  for i in range(0, len(models), 97))
    with env_pin("MM_SOLVER_SPARSE", "1"):
        sols = [dispatch_solve(cache.cols, seed=strat._seed,
                               config=steady_solve_config(), base=base,
                               dirty_rows=rows, device=dev).sol
                for _ in range(2)]
    fields = ("indices", "valid", "load", "overflow")
    differs = [f for f in fields
               if not same_bytes(getattr(sols[0], f), getattr(sols[1], f))]
    check(not differs, f"steady: two incremental re-solves on one base "
          f"differ in {differs}")
    return {"fields": list(fields), "dirty_rows": len(rows),
            "byte_identical": True}


def steady_parity(dev) -> dict:
    """The same churn (3 cycles) at the parity fleet through a CPU
    strategy (plain versions) and a CUDA one: each takes the incremental
    path at least once; on the last plans placement agreement >= 0.97 and
    overflow within 0.5% of demand."""
    fleet = steady_records(*PARITY_FLEET)
    models, instances, rpm, _ = fleet
    demand = demand_of(snapshot_columns(models, instances, rpm))
    strats = {"cpu": new_strategy("cpu", 0.05), "gpu": new_strategy(dev, 0.05)}
    paths = {k: [] for k in strats}
    with env_pin("MM_SOLVER_SPARSE", "1"):
        plans = {k: st.refresh(models, instances, rpm)
                 for k, st in strats.items()}
        for _ in range(STEADY_PARITY_CYCLES):
            dirty = churn(fleet)
            for k, st in strats.items():
                st.mark_dirty(dirty, [])
                plans[k] = st.refresh(models, instances, rpm,
                                      incremental=True)
                paths[k].append(plans[k].stats["solver_path"])
    for k in strats:
        check("incremental" in paths[k],
              f"steady parity: the {k} strategy never took the "
              f"incremental path ({paths[k]})")
    gpu, cpu = plans["gpu"], plans["cpu"]
    agree = float(np.mean([gpu.lookup(mid) == cpu.lookup(mid)
                           for mid, _ in models]))
    d_over = abs(gpu.stats["overflow"] - cpu.stats["overflow"])
    out = {"models": PARITY_FLEET[0], "instances": PARITY_FLEET[1],
           "cycles": STEADY_PARITY_CYCLES, "paths": paths,
           "agreement": agree, "overflow_gpu": gpu.stats["overflow"],
           "overflow_cpu": cpu.stats["overflow"],
           "overflow_diff_frac": d_over / demand}
    check(agree >= 0.97, f"steady parity: GPU/CPU agreement {agree}")
    check(d_over <= 0.005 * demand,
          f"steady parity: overflow differs by {d_over}")
    return out


def steady_row_lse(dev, card: str) -> dict:
    """Kernel 4 at the steady cell's shape, bf16 [1024, 1024] (the dirty
    rows padded to 1024): against its plain version, timed beside its
    bound and torch.logsumexp over a materialized f32 z."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    op = lse_operands(STEADY_LSE_SHAPE, gen)
    case = check_lse_kernels(op, "steady")
    timed = lse_times(op, case["errors"], card)["row_lse_partial"]
    # At this size a call's host time can exceed its device time.
    timed["kernel_split_ms"] = kernel_split_ms(
        lse_calls(op)["row_lse_partial"][0], KERNEL_REPS)
    return timed


def phase_steady(dev, card: str) -> dict:
    """The steady state at the main fleet (bench.py's
    _measure_solver_paths, run_path("1", 0.05) and run_path("1", 0.0)):
    model-only churn of 1% of models a cycle, refreshed incrementally,
    first with the dirty-row re-solve allowed, then with full warm sparse
    solves on delta snapshots."""
    fleet = steady_records(*MAIN_FLEET)
    models, instances, rpm, _ = fleet
    demand = demand_of(snapshot_columns(models, instances, rpm))
    incr = steady_run(dev, fleet, 0.05, "steady", demand)
    s_incr = incr["summary"]
    check(s_incr["incremental_cycles"] >= STEADY_MIN_INCREMENTAL,
          f"steady: {s_incr['incremental_cycles']} of {STEADY_CYCLES} "
          f"cycles took the incremental path ({s_incr['paths']})")
    repeatable = check_incremental_repeatable(dev, incr["strategy"], fleet)
    stages = steady_stages(dev, incr["strategy"], fleet)
    full = steady_run(dev, fleet, 0.0, "steady_full_warm", demand)
    result = {"phase": "steady", "card": card, "models": MAIN_FLEET[0],
              "instances": MAIN_FLEET[1], "padded": list(TIER),
              "churn_per_cycle": MAIN_FLEET[0] // 100,
              "incremental": s_incr, "full_warm": full["summary"],
              "repeatable": repeatable, **stages,
              "parity": steady_parity(dev),
              "row_lse_at_steady_shape": steady_row_lse(dev, card)}
    emit(result)
    return result


PIPELINED_CYCLES = 6
PIPELINED_MIN_INCREMENTAL = 4


def add_launches(total: dict, got: dict) -> None:
    for name, n in got.items():
        total[name] = total.get(name, 0) + n


def pipelined_submit(refresher, fleet, dev, dirty, total: dict) -> dict:
    """One pipelined submit (or, with ``dirty`` None, the drain): the churn
    marked dirty, the launch counters zeroed just before and read just
    after, the host syncs across it."""
    models, instances, rpm, _ = fleet
    strat = refresher.strategy
    if dirty:
        strat.mark_dirty(dirty, [])
    torch.cuda.synchronize(dev)
    reset_all_launches()
    syncs0 = device_mod.host_syncs
    t = time.perf_counter()
    plan = (refresher.drain() if dirty is None
            else refresher.submit(models, instances, rpm, incremental=True))
    wall_ms = (time.perf_counter() - t) * 1e3
    launches = all_launches()
    add_launches(total, launches)
    flight = refresher._inflight
    out = {"wall_ms": wall_ms, "host_syncs": device_mod.host_syncs - syncs0,
           "launches": launches, "plan": plan,
           "base_overflow": (strat._base.overflow
                             if strat._base is not None else None)}
    if flight is not None:
        p = flight.pending
        out.update(path=p.path, dirty_rows=p.dirty_rows,
                   snapshot_ms=(p.t_snapshot - p.t_start) * 1e3,
                   dispatch_ms=(p.t_dispatched - p.t_snapshot) * 1e3,
                   generation=flight.generation)
    if plan is not None:
        out.update(emitted_generation=plan.generation,
                   emitted_path=plan.stats["solver_path"],
                   readback_wait_ms=plan.stats["readback_wait_ms"],
                   overflow=plan.stats["overflow"],
                   emitted_host_syncs=plan.stats["host_syncs"])
    return out


def pipelined_run(dev) -> dict:
    """The main fleet (``steady_records``) twice from one seed, so both
    refresh paths see the same churn, under the sparse pin and the steady
    gates: a blocking strategy after a cold refresh, and a pipelined
    refresher after its priming submit, then PIPELINED_CYCLES cycles of 1%
    model churn, each cycle running both paths in turns (blocking first
    on even cycles, pipelined first on odd ones, so host drift falls on
    both alike), and the drain."""
    from modelmesh_tpu_torch.placement.refresh_loop import PipelinedRefresher

    blocking_fleet = steady_records(*MAIN_FLEET)
    fleet = steady_records(*MAIN_FLEET)
    models, instances, rpm, _ = blocking_fleet
    total: dict = {}
    blocking, cycles = [], []
    with env_pin("MM_SOLVER_SPARSE", "1"):
        strat = new_strategy(dev, 0.05)
        strat.refresh(models, instances, rpm)
        refresher = PipelinedRefresher(new_strategy(dev, 0.05))
        prime = pipelined_submit(refresher, fleet, dev, [], total)
        check(prime["plan"] is None, "pipelined: the priming submit "
              "returned a plan")
        for i in range(PIPELINED_CYCLES):
            dirty_b, dirty_p = churn(blocking_fleet), churn(fleet)
            check(dirty_b == dirty_p, "pipelined: the two fleets' churn "
                  "differs")
            turns = [
                lambda: blocking.append(
                    steady_cycle(strat, blocking_fleet, dev, dirty_b)),
                lambda: cycles.append(
                    pipelined_submit(refresher, fleet, dev, dirty_p, total)),
            ]
            for turn in (turns if i % 2 == 0 else turns[::-1]):
                turn()
        tail = pipelined_submit(refresher, fleet, dev, None, total)
    return {"blocking": blocking, "prime": prime, "cycles": cycles,
            "tail": tail, "launches": total}


def check_pipelined(run: dict, demand: float) -> dict:
    """Every generation emitted once and in order; each incremental cycle
    (the flight it dispatched) with at most one host sync and kernel 4
    and the implied load once each, nothing else; the emitted plans within
    the base's overflow + 0.5% of demand; at least
    PIPELINED_MIN_INCREMENTAL incremental cycles."""
    cycles, tail = run["cycles"], run["tail"]
    emitted = [c["emitted_generation"] for c in cycles + [tail]
               if c["plan"] is not None]
    first = run["prime"]["generation"]
    check(emitted == list(range(first, first + len(cycles) + 1)),
          f"pipelined: generations emitted {emitted}")
    incr = [c for c in cycles if c["path"] == "incremental"]
    check(len(incr) >= PIPELINED_MIN_INCREMENTAL,
          f"pipelined: {len(incr)} of {len(cycles)} cycles incremental "
          f"({[c['path'] for c in cycles]})")
    for c in incr:
        check(c["host_syncs"] <= 1,
              f"pipelined: {c['host_syncs']} host syncs in an incremental "
              "cycle")
        want = dict.fromkeys(c["launches"], 0)
        want.update(row_lse_partial=1, implied_load=1)
        check(c["launches"] == want, f"pipelined: launches in an "
              f"incremental cycle {c['launches']}, want {want}")
    for c in cycles + [tail]:
        if c["plan"] is None:
            continue
        check(c["plan"].stats["pipelined"] is True,
              "pipelined: a plan not marked pipelined")
        if c["emitted_path"] == "incremental":
            check(c["base_overflow"] is not None
                  and c["overflow"] <= c["base_overflow"] + 0.005 * demand,
                  f"pipelined: plan overflow {c['overflow']} past the "
                  f"base's {c['base_overflow']} + 0.5% of demand")
    for name in ("select_candidates", "masked_sinkhorn_step",
                 "masked_row_matvec", "row_lse_partial", "implied_load"):
        check(run["launches"].get(name, 0) > 0,
              f"pipelined: {name} was not launched")

    def keep(c):
        return {k: v for k, v in c.items() if k != "plan"}

    blocking_wall = [c["wall_ms"] for c in run["blocking"]]
    pipelined_wall = [c["wall_ms"] for c in cycles]
    # Cycle by cycle, the pipelined submit less the blocking refresh, on
    # the cycles whose pipelined flight is incremental.
    paired = [p["wall_ms"] - b["wall_ms"]
              for p, b in zip(cycles, run["blocking"])
              if p["path"] == "incremental"]
    return {
        "cycles": [keep(c) for c in cycles], "prime": keep(run["prime"]),
        "drain": keep(tail),
        "blocking_cycles": [
            {"wall_ms": c["wall_ms"], "path": c["stats"]["solver_path"],
             "dirty_rows": c["stats"].get("dirty_rows"),
             "host_syncs": c["host_syncs"],
             "solve_ms": c["stats"]["solve_ms"],
             "snapshot_ms": c["stats"]["snapshot_ms"],
             "extract_ms": c["stats"]["extract_ms"],
             "readback_wait_ms": c["stats"]["readback_wait_ms"],
             "dispatch_ms": c["stats"].get("dispatch_ms")}
            for c in run["blocking"]],
        "summary": {
            "blocking_wall_ms": summary(blocking_wall),
            "pipelined_wall_ms": summary(pipelined_wall),
            "pipelined_wall_ms_incremental": summary(
                [c["wall_ms"] for c in incr]),
            "pipelined_less_blocking_ms": summary(paired),
            "first": ["blocking" if i % 2 == 0 else "pipelined"
                      for i in range(len(cycles))],
            "blocking_paths": [c["stats"]["solver_path"]
                               for c in run["blocking"]],
            "pipelined_paths": [c["path"] for c in cycles],
            "incremental_cycles": len(incr),
            "readback_wait_ms": summary([c["readback_wait_ms"]
                                         for c in cycles]),
            "dispatch_ms_incremental": summary(
                [c["dispatch_ms"] for c in incr]),
        },
        "launches_in_run": run["launches"],
    }


def pipelined_parity(dev) -> dict:
    """The pipelined sequence at the parity fleet, PIPELINED_PARITY_CYCLES
    churn cycles after a priming submit and then the drain, through a
    CPU strategy (plain versions) and a CUDA one: the emitted plans' paths
    equal; on the drained plans agreement >= 0.97 and overflow within
    0.5% of demand."""
    from modelmesh_tpu_torch.placement.refresh_loop import PipelinedRefresher

    fleet = steady_records(*PARITY_FLEET)
    models, instances, rpm, _ = fleet
    demand = demand_of(snapshot_columns(models, instances, rpm))
    refs = {"cpu": PipelinedRefresher(new_strategy("cpu", 0.05)),
            "gpu": PipelinedRefresher(new_strategy(dev, 0.05))}
    paths = {k: [] for k in refs}
    with env_pin("MM_SOLVER_SPARSE", "1"):
        for r in refs.values():
            r.submit(models, instances, rpm)
        for _ in range(STEADY_PARITY_CYCLES):
            dirty = churn(fleet)
            for k, r in refs.items():
                r.strategy.mark_dirty(dirty, [])
                plan = r.submit(models, instances, rpm)
                paths[k].append(plan.stats["solver_path"])
        plans = {k: r.drain() for k, r in refs.items()}
    for k, plan in plans.items():
        paths[k].append(plan.stats["solver_path"])
    check(paths["cpu"] == paths["gpu"],
          f"pipelined parity: paths differ {paths}")
    check("incremental" in paths["gpu"],
          f"pipelined parity: no incremental cycle {paths}")
    gpu, cpu = plans["gpu"], plans["cpu"]
    agree = float(np.mean([gpu.lookup(mid) == cpu.lookup(mid)
                           for mid, _ in models]))
    d_over = abs(gpu.stats["overflow"] - cpu.stats["overflow"])
    check(agree >= 0.97, f"pipelined parity: GPU/CPU agreement {agree}")
    check(d_over <= 0.005 * demand,
          f"pipelined parity: overflow differs by {d_over}")
    return {"models": PARITY_FLEET[0], "instances": PARITY_FLEET[1],
            "cycles": STEADY_PARITY_CYCLES, "paths": paths,
            "agreement": agree, "overflow_diff_frac": d_over / demand}


def phase_pipelined(dev, card: str) -> dict:
    """The pipelined steady refresh (``placement/refresh_loop.py``) at the
    main fleet beside the blocking one on identical churn, then GPU/CPU
    parity of the pipelined sequence."""
    models, instances, rpm, _ = steady_records(*MAIN_FLEET)
    demand = demand_of(snapshot_columns(models, instances, rpm))
    run = pipelined_run(dev)
    result = {"phase": "pipelined", "card": card, "models": MAIN_FLEET[0],
              "instances": MAIN_FLEET[1],
              "churn_per_cycle": MAIN_FLEET[0] // 100,
              **check_pipelined(run, demand),
              "parity": pipelined_parity(dev)}
    emit(result)
    emit({"phase": "pipelined_summary", **result["summary"]})
    return result


def random_ops():
    """The threefry wrappers, imported where a phase needs them (as
    ``load_ops``)."""
    from modelmesh_tpu_torch import random as prng
    from modelmesh_tpu_torch.ops import cuda_random

    return prng, cuda_random


def phase_threefry(dev, card: str, cols) -> dict:
    """JAX's threefry Gumbel draw on the card: the kernel against its plain
    version (bits and Gumbel values bitwise) at THREEFRY_SHAPES, the card's
    bits against the CPU's, the Gumbel values bitwise at the tier; its time
    per launch at the tier beside its bound, the plain version and
    torch.rand + two logs; one dense solve of
    the main fleet with noise_impl="threefry" at tau 1 (one draw a solve,
    counters zeroed just before it); the dense parity fleet under the pin
    on the card and on the CPU."""
    prng, cuda_random = random_ops()
    key = prng.PRNGKey(SEED)
    checked = {}
    for tag, shape in THREEFRY_SHAPES.items():
        bits = cuda_random.random_bits(key, shape, dev)
        g = cuda_random.gumbel(key, shape, dev)
        ref_bits = prng.random_bits(key, 32, shape, dev)
        ref_g = prng.gumbel(key, shape, dev)
        checked[tag] = {
            "shape": list(shape),
            "bits_differ": int((bits != ref_bits).sum().item()),
            "gumbel_differ": bitwise_differs(g, ref_g),
            "max_abs_err": max_abs(g, ref_g),
            "finite": bool(torch.isfinite(g).all().item()),
        }
        check(torch.equal(bits, ref_bits),
              f"threefry {tag}: bits differ from the plain version")
        check(same_bytes(g, ref_g),
              f"threefry {tag}: Gumbel values differ from the plain version")
        check(checked[tag]["finite"], f"threefry {tag}: non-finite draw")
    block = THREEFRY_SHAPES["block"]
    cpu_bits = prng.random_bits(key, 32, block, "cpu")
    card_bits = cuda_random.random_bits(key, block, dev).cpu()
    check(torch.equal(card_bits, cpu_bits),
          "threefry: the card's bits differ from the CPU's")
    cpu_g = prng.gumbel(key, block, "cpu")
    checked["card_vs_cpu"] = {
        "bits_equal": True,
        "gumbel_max_abs_err": max_abs(
            cuda_random.gumbel(key, block, dev).cpu(), cpu_g),
    }
    # At the tier's shape, the main path's: the plain draw kept from its
    # timing and held against the kernel's bitwise.
    n, m = TIER
    tiny = torch.finfo(torch.float32).tiny
    plain = {}

    def plain_draw():
        plain["g"] = prng.gumbel(key, TIER, dev)

    plain_ms = time_ms(plain_draw, 1)
    g = cuda_random.gumbel(key, TIER, dev)
    checked["tier"] = {
        "shape": list(TIER),
        "gumbel_differ": bitwise_differs(g, plain["g"]),
        "max_abs_err": max_abs(g, plain["g"]),
        "finite": bool(torch.isfinite(g).all().item()),
    }
    check(same_bytes(g, plain["g"]),
          "threefry tier: Gumbel values differ from the plain version")
    check(checked["tier"]["finite"], "threefry tier: non-finite draw")
    del g, plain["g"]
    timed = {
        "shape": list(TIER),
        "max_abs_err": checked["tier"]["max_abs_err"],
        "ms": time_ms(lambda: cuda_random.gumbel(key, TIER, dev),
                      KERNEL_REPS),
        "plain_ms": plain_ms,
        # One library draw of the same distribution (other bits).
        "library_ms": time_ms(
            lambda: -torch.log(-torch.log(
                torch.rand(TIER, device=dev).clamp_min_(tiny))),
            KERNEL_REPS),
        **bound("threefry_gumbel", n * m * 4, n * m, card),
    }

    cuda_load = load_ops()
    with dense_pin(), env_pin("MM_SOLVER_NOISE_IMPL", "threefry"):
        cfg = solve_config_from_env()
        check(cfg.noise_impl == "threefry" and cfg.tau > 0,
              f"threefry pin not in the config: {cfg}")
        finalize_plan(dispatch_solve(cols, seed=3_000_000, config=cfg,
                                     device=dev))      # warm-up
        torch.cuda.synchronize()
        cuda_random.reset_launches()
        cuda_lse.reset_launches()
        cuda_load.reset_launches()
        t = time.perf_counter()
        plan = finalize_plan(dispatch_solve(cols, seed=300, config=cfg,
                                            device=dev))
        wall_ms = (time.perf_counter() - t) * 1e3
        launches = dict(cuda_random.launches, **cuda_lse.launches,
                        **cuda_load.launches)
        parity = phase_parity(dev, DENSE_PARITY_FLEET, "threefry_parity",
                              "dense")
    st = plan.stats
    demand = demand_of(cols)
    check(st["solver_path"] == "dense", f"threefry solve: {st['solver_path']}")
    check(math.isfinite(st["overflow"]) and st["overflow"] >= 0,
          "threefry solve: overflow not finite")
    check(launches["threefry_gumbel"] == 1 and launches["threefry_bits"] == 0,
          f"threefry solve launches {launches}")
    check(parity["launches"]["threefry_gumbel"] == 1,
          f"threefry_parity launches {parity['launches']}")
    solve = {
        "models": MAIN_FLEET[0], "instances": MAIN_FLEET[1],
        "padded": list(TIER), "pin": "MM_SOLVER_SPARSE=0",
        "noise_impl": "threefry", "tau": cfg.tau, "wall_ms": wall_ms,
        "solve_ms": st["solve_ms"], "extract_ms": st["extract_ms"],
        "overflow_frac": st["overflow"] / demand, "row_err": st["row_err"],
        "auction_iters_run": st["auction_iters_run"],
        "launches": launches,
    }
    emit({"phase": "threefry", "card": card, "checked": checked,
          "threefry_gumbel": timed, "dense_solve": solve})
    return {"threefry_gumbel": timed, "launches": launches}


# The sharded phase: mesh shapes (mdl, inst), every shard on the one card,
# the main fleet's sparse solve on each, and the pinned dense solve on the
# first three; solves timed per shape after a warm-up, all at one seed.
SHARDED_SHAPES = ((1, 1), (8, 1), (4, 2), (2, 4))
SHARDED_DENSE_SHAPES = ((1, 1), (8, 1), (4, 2))
SHARDED_SOLVES = 3
SHARDED_SEED = 4242


def mesh_ops():
    """The mesh and its solver, imported where a phase needs them (as
    ``load_ops``)."""
    from modelmesh_tpu_torch.parallel import mesh as mesh_mod

    return mesh_mod


def sharded_kernels(dev) -> dict:
    """The column reductions' partial route on the card: each wrapper run
    on the 8 row blocks of C bf16[131072, 1024] (an 8 x 1 mesh on this
    card, the blocks' partials combined once over the model axis) against
    the same wrapper on the whole of C, bit for bit: the fused sparse pass
    and the column-only product (c), the fused LSE step and the column
    LSE ((m, s)), the implied load at int64[131072, 8] -> 1024."""
    mesh_mod = mesh_ops()
    cuda_load = load_ops()
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    n, m = TIER
    C = (torch.rand(TIER, generator=gen, device=dev) * 4).to(torch.bfloat16)
    x_row, kw = selection_operands(C)
    sel = cuda_sparse.select_candidates(C, x_row, SPARSE_K, **kw)
    v = torch.rand(m, generator=gen, device=dev)
    u = torch.rand(n, generator=gen, device=dev) + 0.5
    g = -torch.rand(m, generator=gen, device=dev)
    f = torch.rand(n, generator=gen, device=dev)
    log_a = torch.log(u)
    idx, valid, sizes = load_operands(gen, n, MAX_COPIES, m)
    eps = SPARSE_EPS

    def calls(rows, col_psum=None):
        bits, rowmin = sel.bits[rows], sel.rowmin[rows]
        return {
            "masked_sinkhorn_step": cuda_sparse.masked_sinkhorn_step(
                C[rows], bits, rowmin, v, u[rows], eps=eps,
                col_psum=col_psum),
            "masked_col_matvec": (cuda_sparse.masked_col_matvec(
                C[rows], bits, rowmin, u[rows], eps=eps,
                col_psum=col_psum),),
            "lse_sinkhorn_step": cuda_lse.lse_sinkhorn_step(
                C[rows], g, log_a[rows], LSE_EPS, col_psum=col_psum),
            "col_lse_partial": cuda_lse.col_lse_partial(
                C[rows], f[rows], LSE_EPS, col_psum=col_psum),
            "implied_load": (cuda_load.implied_load(
                idx[rows], valid[rows], sizes[rows], m, col_psum=col_psum),),
        }

    whole = calls(slice(None))
    mesh = mesh_mod.make_mesh((8, 1), [dev] * 8)
    try:
        def shard():
            blk = n // 8
            i = mesh_mod.axis_index(mesh_mod.MODEL_AXIS)
            return calls(slice(i * blk, (i + 1) * blk),
                         mesh_mod.AxisSum(mesh_mod.MODEL_AXIS))

        outs = mesh_mod.shard_map(shard, mesh)()
    finally:
        mesh.close()
    torch.cuda.synchronize()
    differs = {}
    for name, want in whole.items():
        # The fused steps' first output is per row (the shard's rows); the
        # rest are per column, whole on every shard.
        per_row = name in ("masked_sinkhorn_step", "lse_sinkhorn_step")
        if per_row:
            differs[f"{name}_rows"] = bitwise_differs(
                torch.cat([o[name][0] for o in outs]), want[0])
        differs[name] = max(
            bitwise_differs(a, b) for o in outs
            for a, b in zip(o[name][per_row:], want[per_row:]))
    check(all(d == 0 for d in differs.values()),
          f"sharded partial routes differ from the whole-C wrappers: "
          f"{differs}")
    return {"shape": list(TIER), "mesh": [8, 1], "bits_differ": differs}


def sharded_compare(sol, want, demand: float) -> dict:
    """A sharded solve's placement against the single-device one's."""
    gi, gv = sol.indices.cpu(), sol.valid.cpu()
    wi, wv = want.indices.cpu(), want.valid.cpu()
    rows_differ = ((gv != wv) | ((gi != wi) & wv)).any(dim=1)
    return {
        "byte_identical": same_bytes(sol.indices, want.indices)
        and same_bytes(sol.valid, want.valid),
        "rows_differ": int(rows_differ.sum()),
        "agreement": 1.0 - float(rows_differ.float().mean()),
        "max_abs_dg": float((sol.g - want.g).abs().max()),
        "overflow_diff_frac": abs(float(sol.overflow) - float(want.overflow))
        / demand,
    }


def sharded_run(dev, cols, cfg, shape, want, demand: float,
                bitwise: bool, same_draw: bool = True) -> dict:
    """One mesh shape: a warm-up solve, then SHARDED_SOLVES solves through
    dispatch_solve(mesh=...) -> finalize_plan at SHARDED_SEED, launch
    counters zeroed just before them and read just after; each solve's
    placement against the single-device one (``want``): byte for byte when
    ``bitwise``, else, or when it is not, the rows that differ, the
    largest |dg|, agreement >= 0.97 (unless the mesh draws other noise:
    not ``same_draw``) and overflow within 0.5% of demand."""
    mesh_mod = mesh_ops()
    _, cuda_random = random_ops()
    mesh = mesh_mod.make_mesh(shape, [dev] * (shape[0] * shape[1]))
    try:
        finalize_plan(dispatch_solve(cols, seed=SHARDED_SEED, config=cfg,
                                     mesh=mesh))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_all_launches()
        cuda_random.reset_launches()
        syncs0 = device_mod.host_syncs
        times, stats, compared = [], [], []
        for _ in range(SHARDED_SOLVES):
            t = time.perf_counter()
            pending = dispatch_solve(cols, seed=SHARDED_SEED, config=cfg,
                                     mesh=mesh)
            plan = finalize_plan(pending)
            times.append((time.perf_counter() - t) * 1e3)
            stats.append(plan.stats)
            compared.append(sharded_compare(pending.sol, want, demand))
        launches = dict(all_launches(), **cuda_random.launches)
        syncs = device_mod.host_syncs - syncs0
        peak = torch.cuda.max_memory_allocated(dev)
        threads = mesh.threads()
    finally:
        mesh.close()
    worst = min(compared, key=lambda c: c["agreement"])
    same = all(c["byte_identical"] for c in compared)
    out = {
        "mesh": list(shape), "path": stats[-1]["solver_path"],
        "solves": SHARDED_SOLVES,
        "wall_ms_median": float(np.median(times)), "wall_ms": times,
        "solve_ms": [st["solve_ms"] for st in stats],
        "dispatch_ms": [st["dispatch_ms"] for st in stats],
        "extract_ms": [st["extract_ms"] for st in stats],
        "sinkhorn_iters_run": [st["sinkhorn_iters_run"] for st in stats],
        "auction_iters_run": [st["auction_iters_run"] for st in stats],
        "overflow_frac": [st["overflow"] / demand for st in stats],
        "launches_per_solve": {k: c / SHARDED_SOLVES
                               for k, c in launches.items() if c},
        "host_syncs_per_solve": syncs / SHARDED_SOLVES,
        "peak_device_bytes": peak,
        "worker_threads": len(set(threads)),
        "byte_identical": same, **{k: worst[k] for k in (
            "rows_differ", "agreement", "max_abs_dg", "overflow_diff_frac")},
        "launches": launches,
    }
    if not same_draw:
        out["reason"] = ("threefry folds each shard's index into its key: "
                         "another draw than the single-device solve's")
    elif not same and shape[1] > 1 and out["path"] == "sharded":
        out["reason"] = ("kernel 4's row pairs combine over inst as M = "
                         "max(m), log(sum(s exp(m - M))) + M, which rounds "
                         "apart from one pass over the whole row")
    elif not same:
        out["reason"] = ("the gate sums (the marginal error's, the total "
                         "demand) add the shards' sums, in another order "
                         "than one sum over the rows")
    emit({"phase": "sharded_shape", **{k: v for k, v in out.items()
                                       if k != "launches"}})
    check(not bitwise or same,
          f"sharded {shape} {out['path']}: not byte for byte the "
          f"single-device placement ({worst})")
    check((worst["agreement"] >= 0.97 or not same_draw)
          and worst["overflow_diff_frac"] <= 0.005,
          f"sharded {shape} {out['path']}: {worst}")
    return out


def phase_sharded(dev, card: str, cols) -> dict:
    """The sharded solve on the card (module docstring, phase 10)."""
    t0 = time.perf_counter()
    kernels = sharded_kernels(dev)
    demand = demand_of(cols)
    totals: dict = {}
    runs = {}

    def single(cfg):
        return dispatch_solve(cols, seed=SHARDED_SEED, config=cfg,
                              device=dev).sol

    def run(tag, cfg, want, shapes, bitwise):
        for shape in shapes:
            got = sharded_run(dev, cols, cfg, shape, want, demand,
                              bitwise(shape))
            runs[f"{tag}_{shape[0]}x{shape[1]}"] = got
            add_launches(totals, got.pop("launches"))

    cfg = solve_config_from_env()
    run("sparse", cfg, single(cfg), SHARDED_SHAPES, lambda s: s == (1, 1))
    mesh = mesh_ops().make_mesh((8, 1), [dev] * 8)
    try:
        phase_profile(dev, cols, "sharded_profile", mesh=mesh)
    finally:
        mesh.close()
    with dense_pin():
        cfg = solve_config_from_env()
        run("dense", cfg, single(cfg), SHARDED_DENSE_SHAPES,
            lambda s: s[1] == 1)
    with dense_pin(), env_pin("MM_SOLVER_NOISE_IMPL", "threefry"):
        # The threefry pin: each shard draws under its own folded key, so
        # the placement is another draw's; held to the quality gates.
        cfg = solve_config_from_env()
        want = single(cfg)
        got = sharded_run(dev, cols, cfg, (8, 1), want, demand, False,
                          same_draw=False)
        runs["dense_threefry_8x1"] = got
        launches = got.pop("launches")
        add_launches(totals, launches)
        check(launches["threefry_gumbel"] == 8 * SHARDED_SOLVES,
              f"sharded threefry launches {launches}")
    for name in ("select_candidates", "masked_row_matvec",
                 "masked_sinkhorn_step", "lse_sinkhorn_step",
                 "row_lse_partial", "col_lse_partial", "implied_load",
                 "threefry_gumbel"):
        check(totals.get(name, 0) > 0,
              f"{name} never launched on the sharded path")
    for tag, got in runs.items():
        check(got["path"] == ("sharded-sparse" if tag.startswith("sparse")
                              else "sharded"), f"{tag}: path {got['path']}")
    result = {"phase": "sharded", "card": card, "models": MAIN_FLEET[0],
              "instances": MAIN_FLEET[1], "padded": list(TIER),
              "seed": SHARDED_SEED, "kernels": kernels,
              "launches_in_run": totals,
              "seconds": time.perf_counter() - t0}
    emit(result)
    return result


# Meshes across cards (phase_sharded_cards): the cards, the shapes.
CARDS = 4
CARD_SHAPES = ((4, 1), (2, 2))


def cards_run(tier: str, cols, devices) -> list:
    """One tier on CARD_SHAPES over ``devices``: a warm-up and
    SHARDED_SOLVES solves per shape at SHARDED_SEED, each placement against
    the single-device one on ``devices[0]``."""
    mesh_mod = mesh_ops()
    cfg = solve_config_from_env()
    demand = demand_of(cols)

    def timed(**where):
        t = time.perf_counter()
        pending = dispatch_solve(cols, seed=SHARDED_SEED, config=cfg,
                                 **where)
        finalize_plan(pending)
        return (time.perf_counter() - t) * 1e3, pending

    timed(device=devices[0])
    single_ms, want = timed(device=devices[0])
    out = []
    for shape in CARD_SHAPES:
        mesh = mesh_mod.make_mesh(shape, devices)
        try:
            timed(mesh=mesh)
            syncs0 = device_mod.host_syncs
            times, compared = [], []
            for _ in range(SHARDED_SOLVES):
                ms, pending = timed(mesh=mesh)
                times.append(ms)
                compared.append(sharded_compare(pending.sol, want.sol,
                                                demand))
            syncs = (device_mod.host_syncs - syncs0) / SHARDED_SOLVES
        finally:
            mesh.close()
        got = {"phase": "sharded_cards", "tier": tier, "mesh": list(shape),
               "devices": [str(d) for d in devices], "path": pending.path,
               "single_ms": single_ms,
               "wall_ms_median": float(np.median(times)), "wall_ms": times,
               "host_syncs_per_solve": syncs, "compare": compared}
        emit(got)
        bitwise = tier == "sparse" or shape[1] == 1
        for c in compared:
            check(c["byte_identical"] or not bitwise,
                  f"sharded_cards {tier} {shape}: not the single-device "
                  f"placement {c}")
            check(c["agreement"] >= 0.97 and c["overflow_diff_frac"] <= 0.005,
                  f"sharded_cards {tier} {shape}: {c}")
        out.append(got)
    return out


def phase_sharded_cards() -> list:
    """The sharded solve across CARDS cards of one host, where the
    collectives copy between devices (phase ``sharded`` holds every shard
    on one card). Not part of ``main``, which needs one card: run it alone
    on a host with four,

        python3 -c 'import chip_smoke as cs; cs.phase_sharded_cards()'

    The main fleet on cuda:0 alone, then on meshes 4x1 and 2x2 over
    cuda:0-3, the sparse path and pinned dense: the sparse shapes and the
    dense whole-row mesh byte for byte the single-device placement, every
    shape agreement >= 0.97 and overflow within 0.5% of demand. Then the
    model runtime across the cards (``runtime_mesh_cards``). Prints every
    card's name and power limit."""
    check(torch.cuda.is_available() and torch.cuda.device_count() >= CARDS,
          f"phase_sharded_cards needs {CARDS} CUDA devices")
    devices = [torch.device("cuda", i) for i in range(CARDS)]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip(), flush=True)
    phase_build()
    cols = steady_fleet(*MAIN_FLEET)
    runs = cards_run("sparse", cols, devices)
    with dense_pin():
        runs += cards_run("dense", cols, devices)
    runs.append(runtime_mesh_cards(devices))
    return runs


def runtime_mesh_cards(devices) -> dict:
    """Phase runtime_mesh's (a), (b) and (d) with one shard on each of
    ``devices``, where the ring's ppermutes, the all_to_alls and the
    split weights cross cards: the ring against the oracle on the first
    card and the same ring on as many CPU shards, the expert-parallel FFN
    against the oracle, and load_sharded over the cards against the plain
    load on the first."""
    t0 = time.perf_counter()
    meshes = runtime_meshes(devices)
    cpu_meshes = runtime_meshes(["cpu"] * len(devices))
    result = {"phase": "runtime_mesh_cards",
              "devices": [str(d) for d in devices],
              "ring": mesh_ring(devices[0], meshes, cpu_meshes),
              "expert_parallel": mesh_ep(devices[0], meshes),
              "serving_mesh": mesh_serving(devices[0], [devices]),
              "seconds": time.perf_counter() - t0}
    emit(result)
    return result


def model_input(model, rows: int, seed: int) -> np.ndarray:
    """Seeded rows of a family's input (token ids for the int families)."""
    rng = np.random.default_rng(seed)
    shape = (rows, *model.input_shape)
    if model.input_dtype == np.int32:
        return rng.integers(-3, 5000, size=shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def check_close(got: np.ndarray, want: np.ndarray, tol, what: str) -> float:
    """|got - want| within rtol / atol·max|want|; returns the largest
    error over max|want|."""
    rtol, atol_frac = tol
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max()) / scale
    check(got.shape == want.shape and np.isfinite(got).all(),
          f"{what}: shape {got.shape} / {want.shape} or non-finite")
    check(bool(np.all(np.abs(got - want)
                      <= atol_frac * scale + rtol * np.abs(want))),
          f"{what}: error {err} of max|ref| past {tol}")
    return err


@contextlib.contextmanager
def moe_routes():
    """Record the port's MoE routing while the block runs: per ``_route``
    call, keyed by (its shard's rank, -1 outside a mesh; the calls that
    shard made before it), each token's expert (-1 when dropped) and the
    top-2 probability margin."""
    import threading

    from modelmesh_tpu_torch.parallel import mesh, moe

    rec, lock, route = {}, threading.Lock(), moe._route

    def recording(x, router, n_experts, capacity):
        dispatch, gate = route(x, router, n_experts, capacity)
        top2 = torch.softmax(x.float() @ router.float(), -1).topk(2).values
        kept = dispatch.sum((1, 2)) > 0
        expert = torch.where(kept, dispatch.sum(2).argmax(1), -1)
        ctx = getattr(mesh._local, "ctx", None)
        rank = -1 if ctx is None else ctx.rank
        with lock:
            calls = sum(1 for key in rec if key[0] == rank)
            rec[(rank, calls)] = (expert.cpu().numpy(),
                                  (top2[:, 0] - top2[:, 1]).cpu().numpy())
        return dispatch, gate

    moe._route = recording
    try:
        yield rec
    finally:
        moe._route = route


def moe_flips(card_rec: dict, cpu_rec: dict, path: str) -> list:
    """The tokens whose expert differs between the card's and the CPU's
    routing, with the CPU's top-2 margin, in call order (a shard's calls
    are its layers); each of the first differing call's must be a
    near-tie."""
    check(sorted(card_rec) == sorted(cpu_rec) and len(cpu_rec) > 0,
          f"{path}: {len(card_rec)} / {len(cpu_rec)} routing calls")
    flips = []
    for call, key in enumerate(sorted(cpu_rec, key=lambda k: (k[1], k[0]))):
        (e_gpu, _), (e_cpu, margin) = card_rec[key], cpu_rec[key]
        for tok in np.nonzero(e_gpu != e_cpu)[0]:
            flips.append({"call": call, "token": int(tok),
                          "card": int(e_gpu[tok]), "cpu": int(e_cpu[tok]),
                          "margin": float(margin[tok])})
    first = [f for f in flips if f["call"] == flips[0]["call"]] if flips \
        else []
    check(all(f["margin"] < MOE_TIE_MARGIN for f in first),
          f"{path}: routing differs away from a near-tie {first}")
    return flips


def serve_families(dev, card: str) -> dict:
    """The gRPC runtime on the card, driven through the port's own stub:
    status, then per family load (timed), weights against a CPU build
    byte for byte, Predict against the CPU path, Predict latency, size,
    unload."""
    import grpc

    from modelmesh_tpu_torch.models import families
    from modelmesh_tpu_torch.models.server import (
        PREDICT_METHOD,
        start_torch_runtime,
    )
    from modelmesh_tpu_torch.proto import mesh_runtime_pb2 as rpb
    from modelmesh_tpu_torch.runtime import grpc_defs

    server, port, servicer = start_torch_runtime(
        capacity_bytes=1 << 30, device=dev)
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        stub = grpc_defs.make_stub(channel, grpc_defs.RUNTIME_SERVICE,
                                   grpc_defs.RUNTIME_METHODS)
        status = stub.RuntimeStatus(rpb.RuntimeStatusRequest(), timeout=60)
        check(status.status == rpb.RuntimeStatusResponse.READY
              and status.runtime_version == "torch-runtime/cuda"
              and status.device_memory_bytes > 0,
              f"runtime status {status}")
        predict = grpc_defs.raw_method(channel, PREDICT_METHOD)
        served = {}
        for family, path in MODEL_SPECS + MOE_SPECS:
            mid = f"smoke-{path}"
            info = rpb.ModelInfo(model_type=family, model_path=path)
            t = time.perf_counter()
            size = stub.LoadModel(rpb.LoadModelRequest(model_id=mid,
                                                       info=info),
                                  timeout=300).size_bytes
            load_ms = (time.perf_counter() - t) * 1e3
            model = servicer.store.get(mid)
            cpu = families.build_model(mid, family, path, device="cpu")
            check(model.device.type == "cuda", f"{path}: not on the card")
            check(size == cpu.size_bytes, f"{path}: size {size}")
            check([families.leaf_bytes(a) for a in
                   families.leaves(model.params)]
                  == [families.leaf_bytes(b) for b in
                      families.leaves(cpu.params)],
                  f"{path}: weights on the card differ from the CPU build")
            md = ((grpc_defs.MODEL_ID_HEADER, mid),)
            x = model_input(cpu, 4, SEED)
            moe = (family, path) in MOE_SPECS
            with moe_routes() as rec:
                out = np.frombuffer(predict(x.tobytes(), metadata=md,
                                            timeout=60), np.float32)
                card_rec = dict(rec)
                rec.clear()
                want = cpu.run(x).reshape(-1)
            flips = moe_flips(card_rec, rec, path) if moe else []
            # A token routed to another expert takes another FFN: the
            # logits are compared only where routing agrees.
            err = (None if flips
                   else check_close(out, want,
                                    MOE_TOL if moe else MODEL_TOL[family],
                                    path))
            one = model_input(cpu, 1, SEED + 1).tobytes()
            lat = []
            for _ in range(PREDICT_CALLS):
                t = time.perf_counter()
                predict(one, metadata=md, timeout=60)
                lat.append((time.perf_counter() - t) * 1e3)
            check(stub.ModelSize(rpb.ModelSizeRequest(model_id=mid),
                                 timeout=60).size_bytes == size,
                  f"{path}: ModelSize")
            stub.UnloadModel(rpb.UnloadModelRequest(model_id=mid),
                             timeout=60)
            check(servicer.store.get(mid) is None, f"{path}: not unloaded")
            served[path] = {
                "size_bytes": size, "load_ms": load_ms,
                "max_err_vs_cpu": err,
                "predict_ms_median": float(np.median(lat)),
                "predict_ms_max": float(np.max(lat)),
            }
            if moe:
                served[path].update(
                    batch_safe=model.batch_safe,
                    routing_calls=len(card_rec),
                    tokens_routed=int(sum(len(r[0])
                                          for r in card_rec.values())),
                    routing_flips=flips)
                check(not model.batch_safe, f"{path}: batch_safe")
        return {"runtime_version": status.runtime_version,
                "device_memory_bytes": status.device_memory_bytes,
                "families": served}
    finally:
        channel.close()
        server.stop(0)


def dispatch_ms(fn) -> float:
    """Median wall ms of ``fn`` over DISPATCH_ROUNDS (each ends in a copy
    to the host), after one warm-up call."""
    fn()
    times = []
    for _ in range(DISPATCH_ROUNDS):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def profile_share(fn) -> dict:
    """One ``fn`` under torch.profiler: wall ms, device busy ms and the
    device's idle share, and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = device_ms_by_kernel(prof)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "launches": sum(c for _, c in by_name.values()),
            "top": [{"name": k, "ms": ms, "count": c}
                    for k, (ms, c) in top]}


def batch_on_card(dev) -> dict:
    """``InProcessTorchLoader`` on the card: per row-independent spec of
    MODEL_SPECS, one same-model micro-batch of FUSED_GROUP requests
    against solo calls; per spec of FUSED_SPECS, one fused group of
    FUSED_GROUP models against the per-model path, timed both ways; a load
    from a CPU loader's weight stream."""
    from modelmesh_tpu_torch.models.server import InProcessTorchLoader
    from modelmesh_tpu_torch.models import families
    from modelmesh_tpu_torch.runtime.spi import BatchItem, ModelInfo

    ld = InProcessTorchLoader(capacity_bytes=1 << 30, device=dev)
    out = {"same_model": {}, "fused": {}}
    mlp = ModelInfo("mlp", "mlp://")
    for k, (family, path) in enumerate(MODEL_SPECS):
        mid = f"same-{k}"
        ld.load(mid, ModelInfo(family, path))
        model = ld.store.get(mid)
        pls = [model_input(model, 1 + i % 3, SEED + i).tobytes()
               for i in range(FUSED_GROUP)]
        solo = [ld.call_model(mid, "", p) for p in pls]
        batched = ld.call_model_batch([BatchItem(mid, payload=p)
                                       for p in pls])
        out["same_model"][path] = {
            "requests": FUSED_GROUP,
            "max_err_vs_solo": max(
                check_close(np.frombuffer(b, np.float32),
                            np.frombuffer(a, np.float32), MODEL_TOL[family],
                            f"{path} same-model batch")
                for a, b in zip(solo, batched)),
        }
        ld.unload(mid)
    for k, (family, path) in enumerate(FUSED_SPECS):
        info = ModelInfo(family, path)
        mids = [f"fused-{k}-{i}" for i in range(FUSED_GROUP)]
        for mid in mids:
            ld.load(mid, info)
        rep = ld.store.get(mids[0])
        check(len({ld.batch_group_key(m) for m in mids}) == 1,
              f"{path}: the group does not share a batch key")
        pls = [model_input(rep, 1 + i % 2, SEED + 10 + i).tobytes()
               for i in range(FUSED_GROUP)]
        items = [BatchItem(m, payload=p) for m, p in zip(mids, pls)]
        ld.store.fused_dispatches = ld.store.fused_fallbacks = 0
        fused = ld.call_model_batch(items)
        counts = (ld.store.fused_dispatches, ld.store.fused_fallbacks)
        check(counts == (1, 0),
              f"{path}: fused dispatches, fallbacks {counts}")
        solo = [ld.call_model(m, "", p) for m, p in zip(mids, pls)]
        err = max(check_close(np.frombuffer(b, np.float32),
                              np.frombuffer(a, np.float32),
                              MODEL_TOL[family], f"{path} fused group")
                  for a, b in zip(solo, fused))
        fused_ms = dispatch_ms(lambda: ld.call_model_batch(items))
        fused_profile = profile_share(lambda: ld.call_model_batch(items))
        ld.store.fused_enabled = False
        per_model_ms = dispatch_ms(lambda: ld.call_model_batch(items))
        per_model_profile = profile_share(
            lambda: ld.call_model_batch(items))
        ld.store.fused_enabled = True
        for mid in mids:
            ld.unload(mid)
        out["fused"][path] = {
            "models": FUSED_GROUP,
            "fused_dispatches": counts[0], "fused_fallbacks": counts[1],
            "max_err_vs_solo": err,
            "fused_ms_median": fused_ms,
            "per_model_ms_median": per_model_ms,
            "fused_profile": fused_profile,
            "per_model_profile": per_model_profile,
        }
        check(ld.store.fused_fallbacks == 0,
              f"{path}: fused dispatch fell back")
    # MoE: a same-model batch of 2 requests and a batch across two MoE
    # models of one architecture run per request, never fused, and equal
    # solo calls bit for bit.
    family, path = MOE_SPECS[0]
    for mid in ("moe-a", "moe-b"):
        ld.load(mid, ModelInfo(family, path))
    rep = ld.store.get("moe-a")
    check(ld.batch_group_key("moe-a") == "moe-a",
          "moe: the model shares a batch key")
    pls = [model_input(rep, 1 + i, SEED + 40 + i).tobytes() for i in (0, 1)]
    ld.store.fused_dispatches = ld.store.fused_fallbacks = 0
    same = ld.call_model_batch([BatchItem("moe-a", payload=p) for p in pls])
    cross = ld.call_model_batch([BatchItem("moe-a", payload=pls[0]),
                                 BatchItem("moe-b", payload=pls[1])])
    check(ld.store.fused_dispatches == 0, "moe: a batch was fused")
    check(same == [ld.call_model("moe-a", "", p) for p in pls]
          and cross == [ld.call_model("moe-a", "", pls[0]),
                        ld.call_model("moe-b", "", pls[1])],
          "moe: a batch differs from its solo calls")
    out["moe_batch"] = {"spec": path, "requests": len(pls),
                        "fused_dispatches": ld.store.fused_dispatches,
                        "bitwise_vs_solo": True}
    cpu = InProcessTorchLoader(capacity_bytes=64 << 20, device="cpu")
    cpu.load("streamed", mlp)
    got = ld.load_from_stream("streamed", mlp,
                              cpu.export_weights("streamed", None)).handle
    check(got.device.type == "cuda", "streamed copy not on the card")
    check([families.leaf_bytes(t) for t in families.leaves(got.params)]
          == [families.leaf_bytes(t) for t in
              families.leaves(cpu.store.get("streamed").params)],
          "streamed weights differ")
    x = model_input(got, 3, SEED + 30).tobytes()
    out["stream_from_cpu"] = {"max_err_vs_cpu": check_close(
        np.frombuffer(ld.call_model("streamed", "", x), np.float32),
        np.frombuffer(cpu.call_model("streamed", "", x), np.float32),
        MODEL_TOL["mlp"], "streamed mlp")}
    return out


def phase_models(dev, card: str) -> dict:
    """A model server answering requests on the card: the gRPC runtime per
    family, then the in-process loader's batching, fused dispatch and
    weight streaming. No custom kernel runs here: the families' products
    are PyTorch's (f32 without TF32, bf16), as the reference leaves them
    to XLA."""
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the f32 families would not be f32")
    result = {"phase": "models", "card": card,
              "grpc": serve_families(dev, card),
              "in_process": batch_on_card(dev)}
    emit(result)
    return result


# The model runtime across a mesh (phase runtime_mesh): every shard on
# the card, one worker thread each, as phase sharded.
MESH_SHARDS = 8
# Ring attention [B, H, S, D]: the reference's multichip dry run, the
# transformer's default width (d=128, 4 heads) at the longest sequence
# the repo's tests serve, and a long context (blocks of 1024).
RING_SHAPES = {"dryrun": (1, 2, 128, 8), "transformer": (2, 4, 128, 32),
               "long": (1, 4, 8192, 32)}
# The reference's gates (tests/test_ring_attention.py), with TF32 off.
RING_TOL = {"f32": 2e-5, "bf16": 3e-2}
RING_REPS = 5
# The expert-parallel FFN (d, ff, experts, tokens): the dry run's, and the
# transformer's default width with 16 experts at 4096 tokens.
EP_SHAPES = {"dryrun": (32, 64, 16, 128), "transformer": (128, 512, 16, 4096)}
EP_TOL = (1e-5, 1e-5)
# The families on the mesh, through the runtime's entry points.
MESH_SPECS = [
    "transformer://seq=128,sp=1",
    "transformer://d=64,heads=4,seq=128,layers=2,sp=1",
    "transformer://experts=16,groups=8,ep=1",
    "transformer://d=64,heads=4,seq=64,layers=2,experts=16,groups=8,ep=1",
]
MESH_ONE_DEVICE_TOL = (0.08, 0.08)      # tests/test_models.py:121,152
MESH_CPU_TOL = (1e-2, 1e-2)             # FORWARD_TOL["transformer"]
# The serving mesh: the default transformer and mlp split over 1, 4 and
# 8 shards of the card.
SERVING_MODELS = [("transformer", "transformer://"), ("mlp", "mlp://")]
SERVING_SHARDS = (1, 4, 8)
SERVING_TOL = dict(rtol=1e-5, atol=1e-5)


def runtime_meshes(devices) -> dict:
    """The runtime's 1-D meshes over ``devices``: the ones the families
    build on (one per axis and device list)."""
    from modelmesh_tpu_torch.parallel import mesh

    return {axis: mesh.axis_mesh(axis, devices) for axis in ("seq", "exp")}


def collective_counts(meshes: dict) -> dict:
    return {axis: dict(m.collectives) for axis, m in meshes.items()}


def clear_collectives(meshes: dict) -> None:
    for m in meshes.values():
        m.collectives.clear()


def wall_ms(fn, reps: int) -> list:
    """Wall ms of ``fn`` (synchronized) over ``reps``, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def mesh_ring(dev, card_meshes: dict, cpu_meshes: dict) -> dict:
    """(a) Ring attention on the card's mesh against the oracle on ``dev``
    and the same ring on as many CPU shards."""
    from modelmesh_tpu_torch.parallel import ring_attention as ra

    n = card_meshes["seq"].size
    out = {}
    gen = torch.Generator().manual_seed(SEED + 50)
    for tag, shape in RING_SHAPES.items():
        qkv32 = [torch.randn(shape, generator=gen) for _ in range(3)]
        for causal in (True, False):
            ring = ra.make_ring_attention(card_meshes["seq"], shape[2],
                                          causal=causal)
            for dtype, dname in ((torch.float32, "f32"),
                                 (torch.bfloat16, "bf16")):
                q, k, v = (t.to(dtype).to(dev) for t in qkv32)
                clear_collectives(card_meshes)
                got = ring(q, k, v)
                torch.cuda.synchronize()
                counts = collective_counts(card_meshes)
                check(counts == {"seq": {"ppermute": 2 * (n - 1)},
                                 "exp": {}},
                      f"ring {tag}: collectives {counts}")
                want = ra.reference_attention(q, k, v, causal=causal)
                tol = RING_TOL[dname]
                err = max_abs(got.float(), want.float())
                check(got.dtype == dtype and got.shape == want.shape
                      and bool(torch.isfinite(got.float()).all())
                      and torch.allclose(got.float(), want.float(),
                                         rtol=tol, atol=tol),
                      f"ring {tag} causal={causal} {dname}: {err} vs the "
                      "oracle on the card")
                rec = {"shape": list(shape), "causal": causal,
                       "dtype": dname, "max_abs_err_vs_oracle": err,
                       "ppermutes": counts["seq"]["ppermute"]}
                if dname == "f32" and (causal or tag != "long"):
                    cpu_ring = ra.make_ring_attention(
                        cpu_meshes["seq"], shape[2], causal=causal)
                    cpu = cpu_ring(*qkv32)
                    cerr = max_abs(got.cpu(), cpu)
                    check(torch.allclose(got.cpu(), cpu, rtol=tol, atol=tol),
                          f"ring {tag} causal={causal}: {cerr} vs the "
                          "8-shard CPU ring")
                    rec["max_abs_err_vs_cpu_ring"] = cerr
                if causal:
                    rec["ring_ms"] = summary(
                        wall_ms(lambda: ring(q, k, v), RING_REPS))
                    rec["oracle_ms"] = summary(wall_ms(
                        lambda: ra.reference_attention(q, k, v, causal),
                        RING_REPS))
                out[f"{tag}_{'causal' if causal else 'full'}_{dname}"] = rec
    return out


def mesh_ep(dev, card_meshes: dict) -> dict:
    """(b) The expert-parallel FFN on the card's mesh against the dense
    oracle with as many routing groups on ``dev``."""
    from modelmesh_tpu_torch import random as prng
    from modelmesh_tpu_torch.parallel import moe

    n = card_meshes["exp"].size
    out = {}
    for tag, (d, ff, n_exp, tokens) in EP_SHAPES.items():
        params = {k: v.to(dev) for k, v in moe.init_moe_params(
            prng.PRNGKey(SEED + 60), d, ff, n_exp).items()}
        x = torch.randn((tokens, d), generator=torch.Generator().manual_seed(
            SEED + 61)).to(dev)
        fn = moe.make_expert_parallel_ffn(card_meshes["exp"], n_exp)
        clear_collectives(card_meshes)
        with moe_routes() as rec:
            got = fn(params, x)
            torch.cuda.synchronize()
            counts = collective_counts(card_meshes)
            want = moe.reference_moe(params, x, n_exp, n_dev=n)
        check(counts == {"seq": {}, "exp": {"all_to_all": 2}},
              f"ep {tag}: collectives {counts}")
        for g in range(n):
            check(np.array_equal(rec[(g, 0)][0], rec[(-1, g)][0]),
                  f"ep {tag}: shard {g} routes otherwise than the oracle")
        dropped = int((want.abs().sum(1) == 0).sum())
        check(bool(torch.equal(got.abs().sum(1) == 0, want.abs().sum(1) == 0)),
              f"ep {tag}: dropped tokens differ")
        err = check_close(got.cpu().numpy(), want.cpu().numpy(), EP_TOL,
                          f"ep {tag}")
        out[tag] = {
            "d": d, "ff": ff, "experts": n_exp, "tokens": tokens,
            "routing_equal": True, "dropped_tokens": dropped,
            "max_err_vs_oracle": err, "all_to_alls": 2,
            "ep_ms": summary(wall_ms(lambda: fn(params, x), RING_REPS)),
            "oracle_ms": summary(wall_ms(
                lambda: moe.reference_moe(params, x, n_exp, n_dev=n),
                RING_REPS)),
        }
    return out


def predict_times(predict, payload: bytes, md) -> dict:
    lat = []
    for _ in range(PREDICT_CALLS):
        t = time.perf_counter()
        predict(payload, metadata=md, timeout=60)
        lat.append((time.perf_counter() - t) * 1e3)
    return {"median": float(np.median(lat)), "max": float(np.max(lat))}


def mesh_families(dev, card_meshes: dict) -> dict:
    """(c) The sp/ep transformers through the runtime's entry points on the
    card's 8-shard device list: the gRPC runtime (Load, Predict, Unload
    through the port's stub) and the in-process loader; logits against the
    same spec on one device and on 8 CPU shards; the collective counts of
    each Predict."""
    import grpc

    from modelmesh_tpu_torch.models import families
    from modelmesh_tpu_torch.models.server import (
        PREDICT_METHOD,
        InProcessTorchLoader,
        start_torch_runtime,
    )
    from modelmesh_tpu_torch.proto import mesh_runtime_pb2 as rpb
    from modelmesh_tpu_torch.runtime import grpc_defs
    from modelmesh_tpu_torch.runtime.spi import ModelInfo

    devices = [dev] * MESH_SHARDS
    cpus = ["cpu"] * MESH_SHARDS
    mesh_rt = start_torch_runtime(capacity_bytes=1 << 30, device=dev,
                                  devices=devices)
    one_rt = start_torch_runtime(capacity_bytes=1 << 30, device=dev)
    channels = [grpc.insecure_channel(f"127.0.0.1:{rt[1]}")
                for rt in (mesh_rt, one_rt)]
    ld = InProcessTorchLoader(capacity_bytes=1 << 30, device=dev,
                              devices=devices)
    out = {}
    try:
        stubs = [grpc_defs.make_stub(ch, grpc_defs.RUNTIME_SERVICE,
                                     grpc_defs.RUNTIME_METHODS)
                 for ch in channels]
        predicts = [grpc_defs.raw_method(ch, PREDICT_METHOD)
                    for ch in channels]
        for path in MESH_SPECS:
            mid = f"mesh-{path}"
            info = rpb.ModelInfo(model_type="transformer", model_path=path)
            sizes = [stub.LoadModel(rpb.LoadModelRequest(model_id=mid,
                                                         info=info),
                                    timeout=300).size_bytes
                     for stub in stubs]
            check(sizes[0] == sizes[1], f"{path}: sizes {sizes}")
            md = ((grpc_defs.MODEL_ID_HEADER, mid),)
            cpu = families.build_model(mid, "transformer", path,
                                       device="cpu", devices=cpus)
            x = model_input(cpu, 2, SEED + 70)
            sp = "sp=1" in path
            layers = len(cpu.params["blocks"])
            rotations = 2 * (MESH_SHARDS - 1) * layers
            want_counts = ({"seq": {"ppermute": rotations}, "exp": {}} if sp
                           else {"seq": {}, "exp": {"all_to_all": 2 * layers}})
            clear_collectives(card_meshes)
            with moe_routes() as rec:
                got = np.frombuffer(predicts[0](x.tobytes(), metadata=md,
                                                timeout=60), np.float32)
                counts = collective_counts(card_meshes)
                card_rec = dict(rec)
                rec.clear()
                want_cpu = cpu.run(x).reshape(-1)
            check(counts == want_counts,
                  f"{path}: collectives of one Predict {counts}")
            one = np.frombuffer(predicts[1](x.tobytes(), metadata=md,
                                            timeout=60), np.float32)
            err_one = check_close(got, one, MESH_ONE_DEVICE_TOL,
                                  f"{path} vs one device")
            flips = [] if sp else moe_flips(card_rec, rec, path)
            # A token routed to another expert takes another FFN: the
            # logits are held to the CPU's where routing agrees.
            err_cpu = (None if flips else
                       check_close(got, want_cpu, MESH_CPU_TOL,
                                   f"{path} vs 8 CPU shards"))
            one_bytes = model_input(cpu, 1, SEED + 71).tobytes()
            times = {"mesh": predict_times(predicts[0], one_bytes, md),
                     "one_device": predict_times(predicts[1], one_bytes, md)}
            # The in-process loader on the same device list.
            ld.load(mid, ModelInfo("transformer", path))
            clear_collectives(card_meshes)
            inproc = np.frombuffer(ld.call_model(mid, "", x.tobytes()),
                                   np.float32)
            check(collective_counts(card_meshes) == want_counts,
                  f"{path}: in-process collectives")
            check_close(inproc, one, MESH_ONE_DEVICE_TOL,
                        f"{path} in-process vs one device")
            for stub in stubs:
                stub.UnloadModel(rpb.UnloadModelRequest(model_id=mid),
                                 timeout=60)
            ld.unload(mid)
            out[path] = {
                "size_bytes": sizes[0], "collectives_per_predict": counts,
                "max_err_vs_one_device": err_one,
                "max_err_vs_cpu_shards": err_cpu, "routing_flips": flips,
                "inprocess_max_abs_vs_grpc": float(np.abs(inproc - got).max()),
                "predict_ms": times,
            }
    finally:
        for ch in channels:
            ch.close()
        for rt in (mesh_rt, one_rt):
            rt[0].stop(0)
    return out


def mesh_serving(dev, device_lists=None) -> dict:
    """(d) The serving mesh: load_sharded over each of ``device_lists``
    (default: 1, 4 and 8 shards of ``dev``) against the plain load on
    ``dev``, the bytes each shard holds, the share load_shard reports, and
    a shard's stream round trip."""
    from modelmesh_tpu_torch.models import families
    from modelmesh_tpu_torch.models.server import InProcessTorchLoader
    from modelmesh_tpu_torch.parallel import mesh
    from modelmesh_tpu_torch.runtime.spi import ModelInfo

    out = {}
    for family, path in SERVING_MODELS:
        info = ModelInfo(family, path)
        plain = InProcessTorchLoader(capacity_bytes=1 << 30, device=dev)
        plain.load("m", info)
        model = plain.store.get("m")
        x = model_input(model, 2, SEED + 80).tobytes()
        want = model.predict_bytes(x)
        rec = {"size_bytes": model.size_bytes,
               "plain_predict_ms": summary(wall_ms(
                   lambda: model.predict_bytes(x), PREDICT_CALLS))}
        for devices in device_lists or [[dev] * n for n in SERVING_SHARDS]:
            n = len(devices)
            ld = InProcessTorchLoader(capacity_bytes=1 << 30, device=dev,
                                      devices=devices)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(dev)
            lm = ld.load_shard("m", info, 0, n)
            torch.cuda.synchronize()
            grown = torch.cuda.memory_allocated(dev) - before
            split = lm.handle
            total = split.size_bytes
            check(total == model.size_bytes and split.fuse_key == "",
                  f"{path} x{n}: size {total} / fuse key")
            check(lm.size_bytes == -(-total // n),
                  f"{path} x{n}: share {lm.size_bytes}")
            params = families.leaves(split.params)
            for r in range(n):
                expect = sum(leaf.numel() * leaf.element_size()
                             // (n if leaf.split else 1) for leaf in params)
                check(mesh.shard_nbytes(split.params, r) == expect,
                      f"{path} x{n}: shard {r} holds "
                      f"{mesh.shard_nbytes(split.params, r)} != {expect}")
            for leaf in (p for p in params if p.split):
                for b, want_dev in zip(leaf.blocks, devices):
                    check(b.device == torch.device(want_dev)
                          and b.untyped_storage().nbytes()
                          == b.numel() * b.element_size(),
                          f"{path} x{n}: a split block is not its own")
            got = split.predict_bytes(x)
            if n == 1:
                check(got == want, f"{path} x1: not bit for bit the plain "
                      "load")
                err = 0.0
            else:
                a, b = (np.frombuffer(v, np.float32) for v in (got, want))
                err = float(np.abs(a - b).max())
                check(np.allclose(a, b, **SERVING_TOL),
                      f"{path} x{n}: {err} from the plain load")
            chunks = list(ld.export_shard_weights("m", split))
            back = InProcessTorchLoader(capacity_bytes=1 << 30, device=dev,
                                        devices=devices)
            rt = back.load_shard_from_stream("m", info, 0, n, iter(chunks))
            check(rt.size_bytes == lm.size_bytes
                  and [families.leaf_bytes(t) for t in
                       families.leaves(rt.handle.params)]
                  == [families.leaf_bytes(t) for t in params]
                  and rt.handle.predict_bytes(x) == got,
                  f"{path} x{n}: the stream round trip differs")
            rec[f"shards_{n}"] = {
                "split_leaves": sum(leaf.split for leaf in params),
                "leaves": len(params),
                "bytes_per_shard": [mesh.shard_nbytes(split.params, r)
                                    for r in range(n)],
                "reported_share": lm.size_bytes,
                "allocated_bytes_on_card": grown,
                "max_abs_vs_plain": err,
                "streamed_chunks": len(chunks),
                "predict_ms": summary(wall_ms(
                    lambda: split.predict_bytes(x), PREDICT_CALLS)),
            }
        out[path] = rec
    return out


def mesh_costs(dev, shards: int = MESH_SHARDS, reps: int = 30) -> dict:
    """The mesh's own host cost on ``shards`` shards of ``dev``: wall ms
    (median of ``reps`` after a warm-up) of an empty run, of a run of
    2·(shards−1) ppermutes of a small tensor (the ring's count), of the
    same with one small device op after each, and of ring attention at
    [1, 2, 128, 8]; per collective, (run − empty run) / collectives."""
    from modelmesh_tpu_torch.parallel import mesh as mesh_mod
    from modelmesh_tpu_torch.parallel import ring_attention as ra

    n_coll = 2 * (shards - 1)
    perm = [(i, (i + 1) % shards) for i in range(shards)]
    small = [torch.zeros(64, device=dev) for _ in range(shards)]
    mesh = mesh_mod.Mesh([dev] * shards, (shards,), ("x",))
    seq = mesh_mod.Mesh([dev] * shards, (shards,), (ra.SEQ_AXIS,))

    def permutes(x, op: bool):
        for _ in range(n_coll):
            x = mesh_mod.ppermute(x, "x", perm)
            if op:
                x = x + 1.0
        return x

    ring = ra.make_ring_attention(seq, 128)
    gen = torch.Generator().manual_seed(SEED + 90)
    qkv = [torch.randn((1, 2, 128, 8), generator=gen).to(dev)
           for _ in range(3)]
    cases = {
        "empty_run": lambda: mesh.run(lambda: None),
        "ppermutes": lambda: mesh.run(lambda x: permutes(x, False),
                                      (small,)),
        "ppermutes_with_op": lambda: mesh.run(lambda x: permutes(x, True),
                                              (small,)),
        "ring_1x2x128x8": lambda: ring(*qkv),
    }
    try:
        got = {name: float(np.median(wall_ms(fn, reps)))
               for name, fn in cases.items()}
    finally:
        mesh.close()
        seq.close()
    return {"shards": shards, "reps": reps, "collectives_per_run": n_coll,
            "median_ms": got,
            "ms_per_collective": {
                name: (got[name] - got["empty_run"]) / n_coll
                for name in ("ppermutes", "ppermutes_with_op")}}


def phase_runtime_mesh(dev, card: str) -> dict:
    """The model runtime across a mesh on the card (module docstring,
    phase 12)."""
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the f32 rings would not be f32")
    t0 = time.perf_counter()
    card_meshes = runtime_meshes([dev] * MESH_SHARDS)
    cpu_meshes = runtime_meshes(["cpu"] * MESH_SHARDS)
    reset_all_launches()
    result = {"phase": "runtime_mesh", "card": card, "shards": MESH_SHARDS}
    seconds = {}
    for part, run in (
            ("ring", lambda: mesh_ring(dev, card_meshes, cpu_meshes)),
            ("expert_parallel", lambda: mesh_ep(dev, card_meshes)),
            ("families", lambda: mesh_families(dev, card_meshes)),
            ("serving_mesh", lambda: mesh_serving(dev)),
            ("mesh_costs", lambda: mesh_costs(dev))):
        t = time.perf_counter()
        result[part] = run()
        seconds[part] = time.perf_counter() - t
    result.update(kernel_launches_in_phase=all_launches(),
                  seconds_by_part=seconds,
                  seconds=time.perf_counter() - t0)
    emit(result)
    return result


PLAN_PREFIX = "mm"
PLAN_PODS = 3
PLAN_TICKS = 5
PLAN_DECISIONS = 1000
PLAN_TTL_S = 2.0              # the pods' session and election TTL
PLAN_DENSE_FLEET = (10_000, 100)
PLAN_BUDGET_S = 90.0
PLAN_WAIT_S = 30.0            # bound of every wait on a watch thread


def cluster_ops():
    """The cluster layer's modules, imported where the phase needs them
    (tools/sparse_kernel_times.py imports this module against trees from
    before them)."""
    import types

    from modelmesh_tpu_torch.kv.memory import InMemoryKV
    from modelmesh_tpu_torch.kv.session import LeaderElection, SessionNode
    from modelmesh_tpu_torch.kv.table import (
        BucketedKVTable, KVTable, TableView,
    )
    from modelmesh_tpu_torch.placement import plan_sync
    from modelmesh_tpu_torch.placement.greedy import GreedyStrategy
    from modelmesh_tpu_torch.placement.shadow import ShadowStrategy
    from modelmesh_tpu_torch.placement.strategy import (
        LOAD_HERE, ClusterView, PlacementRequest,
    )
    from modelmesh_tpu_torch.placement.torch_engine import GlobalPlan
    from modelmesh_tpu_torch.records import InstanceRecord, ModelRecord
    from modelmesh_tpu_torch.serving.tasks import reaper_plan_step

    return types.SimpleNamespace(**locals())


def wait_until(pred, what: str, timeout: float = PLAN_WAIT_S) -> None:
    """Poll ``pred`` until true; fails the phase past ``timeout``."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise RuntimeError(f"chip_smoke: {what} not within {timeout} s")
        time.sleep(0.0002)


class Pod:
    """One serving instance's share of the cluster layer, wired as the
    reference's ModelMeshInstance wires it: an ephemeral session for its
    instance record, a leader-election candidacy, a plan follower feeding
    its strategy, and a watch-fed view of the instances."""

    def __init__(self, ops, kv, iid: str, rec, strategy):
        self.iid = iid
        self.strategy = strategy
        self.view = ops.TableView(ops.KVTable(
            kv, f"{PLAN_PREFIX}/instances", ops.InstanceRecord))
        self.session = ops.SessionNode(
            kv, f"{PLAN_PREFIX}/instances/{iid}", rec.to_bytes(),
            ttl_s=PLAN_TTL_S)
        self.session.start()
        self.election = ops.LeaderElection(
            kv, f"{PLAN_PREFIX}/leader", iid, lambda is_leader: None,
            ttl_s=PLAN_TTL_S)
        self.election.start()
        self.follower = ops.plan_sync.PlanFollower(kv, PLAN_PREFIX, strategy)
        # The strategy that holds the adopted plan (a shadow pod's solver).
        self.holder = getattr(strategy, "shadow", strategy)

    def leave(self) -> None:
        """The pod goes away: its candidacy and its session end."""
        self.election.close()
        self.session.close()

    def close(self) -> None:
        self.follower.close()
        self.view.close()
        self.leave()


class PlanCluster:
    """A port InMemoryKV holding a fleet's registry (models through a
    BucketedKVTable, instances through a KVTable) and ``pods`` pods, the
    first ``pods`` instances. Close it in a finally."""

    def __init__(self, ops, fleet, dev, pods: int):
        t0 = time.perf_counter()
        models, instances, self.rpm, _ = fleet
        self.ops = ops
        self.kv = ops.InMemoryKV()
        self.pods = []
        try:
            self.registry = ops.BucketedKVTable(
                self.kv, f"{PLAN_PREFIX}/registry", ops.ModelRecord)
            for mid, mr in models:
                self.registry.put(mid, mr)
            table = ops.KVTable(self.kv, f"{PLAN_PREFIX}/instances",
                                ops.InstanceRecord)
            for iid, rec in instances[pods:]:
                table.put(iid, rec)
            for iid, rec in instances[:pods]:
                self.pods.append(Pod(
                    ops, self.kv, iid, rec,
                    TorchPlacementStrategy(device=dev)))
            for pod in self.pods:
                wait_until(lambda p=pod: len(p.view) == len(instances),
                           f"{pod.iid}'s view of {len(instances)} instances")
        except BaseException:
            self.close()
            raise
        # The last tick's plan (before any truncation) and the records its
        # step scanned.
        self.last_plan, self.last_records = None, None
        self.setup_s = time.perf_counter() - t0

    def leader(self):
        leaders = [p for p in self.pods if p.election.is_leader]
        check(len(leaders) == 1, f"plan_loop: {len(leaders)} leaders")
        return leaders[0]

    def published(self):
        return self.kv.get(self.ops.plan_sync.plan_key(PLAN_PREFIX))

    def close(self) -> None:
        for pod in self.pods:
            pod.close()
        self.kv.close()


def plan_tick(dev, cluster, *, new_leader: bool = False,
              profile: bool = False) -> dict:
    """One reaper plan step on the elected leader, then its gates: the
    step published (generation one more than the KV held, or a new
    leader's first), every pod adopted the published bytes, and the
    leader's placements are those of dispatch_solve -> finalize_plan on
    the snapshot its refresh built, with the seed and carry it took."""
    ops = cluster.ops
    leader = cluster.leader()
    strat = leader.strategy
    before = cluster.published()
    gen_before = (ops.GlobalPlan.from_bytes(before.value).generation
                  if before is not None else 0)
    rev_before = before.mod_rev if before is not None else 0
    # A full refresh rotates the seed and carries g, not the prices.
    seed, warm_g = strat._seed + 1, strat._warm_g
    refreshes_before = strat._generation
    torch.cuda.synchronize(dev)
    reset_all_launches()
    syncs0 = device_mod.host_syncs
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as profiler

        prof = profiler(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
        prof.__enter__()
    t = time.perf_counter()
    step = ops.reaper_plan_step(cluster.kv, PLAN_PREFIX, strat,
                                cluster.registry, leader.view, cluster.rpm)
    t_put = time.perf_counter()
    step_ms = (t_put - t) * 1e3
    check(step.plan is not None, f"plan_loop: the step failed: {step.error!r}")
    # Each pod's adoption, from the put's return to its strategy holding
    # the decoded plan; every follower adopts on the store's one dispatch
    # thread, in turn.
    adopt_ms = {}
    pending = list(cluster.pods)

    def all_adopted():
        now = time.perf_counter()
        for pod in list(pending):
            plan = pod.holder.plan
            if (plan is not None and plan is not step.plan
                    and plan.generation == step.plan.generation):
                adopt_ms[pod.iid] = (now - t_put) * 1e3
                pending.remove(pod)
        return not pending

    wait_until(all_adopted, "every pod adopting the plan")
    launches, syncs = all_launches(), device_mod.host_syncs - syncs0
    result = {}
    if prof is not None:
        torch.cuda.synchronize(dev)
        prof.__exit__(None, None, None)
        by_name = device_ms_by_kernel(prof)
        busy = sum(ms for ms, _ in by_name.values())
        result["profiled"] = {"step_ms": step_ms, "device_busy_ms": busy,
                              "device_idle_share": 1.0 - busy / step_ms}
    kv = cluster.published()
    plan = step.plan
    cluster.last_plan, cluster.last_records = plan, step.records
    check(kv is not None and kv.mod_rev > rev_before,
          "plan_loop: the tick published nothing")
    # The generation is the leader strategy's refresh count: one more
    # than the KV held, or, for a new leader, its own first.
    want_gen = refreshes_before + 1 if new_leader else gen_before + 1
    check(plan.generation == want_gen,
          f"plan_loop: published generation {plan.generation}, the KV held "
          f"{gen_before}, the leader had refreshed {refreshes_before} times")
    check(ops.GlobalPlan.from_bytes(kv.value).generation == plan.generation,
          "plan_loop: the KV holds another generation than the step's")
    check(step.nbytes == len(kv.value), "plan_loop: published size")
    for pod in cluster.pods:
        check(pod.holder.plan.to_bytes() == kv.value,
              f"plan_loop: {pod.iid} adopted other bytes than published")
    for name in ("select_candidates", "masked_sinkhorn_step",
                 "masked_row_matvec", "implied_load"):
        if plan.stats["solver_path"] == "sparse":
            check(launches[name] > 0, f"plan_loop: {name} never launched")
    # The snapshot the leader solved is the one of the records it
    # scanned: every column but the two read against the clock at
    # snapshot time (rates of models without rpm, instances' LRU ages).
    cols = strat._snap_cache.cols
    fresh = snapshot_columns(step.records, step.views, cluster.rpm,
                             constraints=strat.constraints)
    for name in cols._fields:
        if name in ("rates", "lru_age"):
            continue
        a, b = getattr(cols, name), getattr(fresh, name)
        check(a == b if isinstance(a, list) else np.array_equal(a, b),
              f"plan_loop: the leader's snapshot column {name} is not the "
              "scanned records'")
    # The leader's placements are the direct solve's on that snapshot and
    # seed, byte for byte.
    direct = finalize_plan(dispatch_solve(
        cols, seed=seed, warm_g=warm_g, warm_price=None,
        config=strat.solve_config, device=dev))
    direct.solved_at_ms, direct.solve_ms = plan.solved_at_ms, plan.solve_ms
    direct.generation = plan.generation
    check(direct.to_bytes() == plan.to_bytes(),
          "plan_loop: the leader's placements differ from dispatch_solve "
          "-> finalize_plan on the same snapshot and seed")
    result.update({
        "leader": leader.iid, "generation": plan.generation,
        "mod_rev": kv.mod_rev, "models": len(step.records),
        "instances": len(step.views), "plan_models": plan.num_models(),
        "published_models": ops.GlobalPlan.from_bytes(kv.value).num_models(),
        "views_ms": step.views_ms, "scan_ms": step.scan_ms,
        "refresh_ms": step.refresh_ms, "solve_ms": plan.solve_ms,
        "snapshot_ms": plan.stats.get("snapshot_ms"),
        "extract_ms": plan.stats.get("extract_ms"),
        "publish_ms": step.publish_ms, "step_ms": step_ms,
        "plan_bytes": step.nbytes, "adopt_ms": adopt_ms,
        "host_syncs": syncs, "solver_path": plan.stats["solver_path"],
        "launches": {k: v for k, v in launches.items() if v},
    })
    return result


def follower_decisions(ops, pod, records, n: int) -> dict:
    """``n`` load decisions on a follower over models sampled evenly from
    the registry: wherever the plan has a usable target the answer is the
    plan's, else greedy's. The share and the µs per decision of each."""
    view = ops.ClusterView(pod.view.items())
    live = {iid for iid, _ in view.placeable()}
    plan = pod.holder.plan
    greedy = ops.GreedyStrategy()
    us = {"plan": [], "greedy": []}
    for mid, mr in records[:: max(1, len(records) // n)][:n]:
        req = ops.PlacementRequest(
            model_id=mid, model=mr, required_units=max(mr.size_units, 1),
            requesting_instance=pod.iid)
        t = time.perf_counter()
        got = pod.strategy.choose_load_target(req, view)
        took = (time.perf_counter() - t) * 1e6
        want = next((iid for iid in plan.lookup(mid) or ()
                     if iid in live and iid not in mr.instance_ids), None)
        if want is not None:
            want = ops.LOAD_HERE if want == pod.iid else want
            check(got == want, f"plan_loop: {mid} answered {got}, the "
                  f"plan says {want}")
            us["plan"].append(took)
        else:
            check(got == greedy.choose_load_target(req, view),
                  f"plan_loop: {mid} answered {got}, not greedy's")
            us["greedy"].append(took)
    total = sum(len(v) for v in us.values())
    return {
        "decisions": total,
        "share_plan": len(us["plan"]) / total,
        "share_greedy": len(us["greedy"]) / total,
        "us_per_decision": {k: float(np.median(v)) if v else None
                            for k, v in us.items()},
    }


def shadow_agreement(ops, cluster, dev, records, n: int) -> dict:
    """A pod running ShadowStrategy(GreedyStrategy(),
    TorchPlacementStrategy()), which operators run before they promote:
    its follower feeds the current plan to the shadow, and it scores the
    same ``n`` load decisions."""
    iid, rec = next((i, r) for i, r in cluster.pods[0].view.items()
                    if i not in {p.iid for p in cluster.pods})
    strat = ops.ShadowStrategy(ops.GreedyStrategy(),
                               TorchPlacementStrategy(device=dev))
    pod = Pod(ops, cluster.kv, iid, rec, strat)
    cluster.pods.append(pod)
    wait_until(lambda: pod.holder.plan is not None,
               "the shadow pod adopting the plan")
    view = ops.ClusterView(pod.view.items())
    for mid, mr in records[:: max(1, len(records) // n)][:n]:
        strat.choose_load_target(ops.PlacementRequest(
            model_id=mid, model=mr, required_units=max(mr.size_units, 1),
            requesting_instance=iid), view)
    stats = strat.shadow_stats()
    counts = stats["counts"]
    check(counts.get("load_shadow_error", 0) == 0,
          f"plan_loop: shadow errors {counts}")
    return {"pod": iid, "counts": counts,
            "load_agreement": stats.get("load_agreement")}


def plan_truncation(dev, cluster, full_bytes: int) -> dict:
    """One tick under MM_MAX_PLAN_BYTES at a quarter of the plan's bytes:
    the pods hold exactly the kept models, and a cut (cold) model is
    answered by greedy."""
    ops = cluster.ops
    with env_pin("MM_MAX_PLAN_BYTES", str(full_bytes // 4)):
        tick = plan_tick(dev, cluster)
    kept = tick["published_models"]
    check(kept < tick["plan_models"] and tick["plan_bytes"] <= full_bytes // 4,
          f"plan_loop: no truncation ({kept} of {tick['plan_models']})")
    for pod in cluster.pods:
        check(pod.holder.plan.num_models() == kept,
              f"plan_loop: {pod.iid} holds {pod.holder.plan.num_models()}"
              f" models, {kept} published")
    pod = next(p for p in cluster.pods if not p.election.is_leader)
    records = dict(cluster.last_records)
    # The solve emits models hottest first: its last one is cut.
    cold = cluster.last_plan._columnar[0][-1]
    check(pod.holder.plan.lookup(cold) is None,
          f"plan_loop: cut model {cold} still in the follower's plan")
    mr = records[cold]
    req = ops.PlacementRequest(model_id=cold, model=mr,
                               required_units=max(mr.size_units, 1),
                               requesting_instance=pod.iid)
    view = ops.ClusterView(pod.view.items())
    got = pod.strategy.choose_load_target(req, view)
    check(got == ops.GreedyStrategy().choose_load_target(req, view),
          f"plan_loop: cut model {cold} answered {got}, not greedy's")
    return dict(tick, budget_bytes=full_bytes // 4, kept_models=kept,
                cold_model=cold, cold_answer=got)


def plan_handover(dev, cluster) -> dict:
    """The leader leaves (its election and session closed): a follower
    becomes leader within the session TTL, and its next tick publishes
    the next plan (a later KV revision; the generation is the new
    leader's own refresh count, as in the reference)."""
    old = cluster.leader()
    t = time.perf_counter()
    old.leave()
    wait_until(lambda: any(p.election.is_leader for p in cluster.pods
                           if p is not old), "a new leader", PLAN_TTL_S)
    handover_ms = (time.perf_counter() - t) * 1e3
    new = cluster.leader()
    wait_until(lambda: old.iid not in new.view,
               f"{old.iid}'s instance record leaving the view")
    rev = cluster.published().mod_rev
    tick = plan_tick(dev, cluster, new_leader=True)
    check(tick["mod_rev"] > rev and tick["leader"] == new.iid,
          "plan_loop: the new leader's tick did not publish")
    return dict(tick, old_leader=old.iid, handover_ms=handover_ms,
                previous_mod_rev=rev)


def phase_plan_loop(dev, card: str) -> dict:
    """The registry and the leader/follower plan loop (module docstring,
    phase 13)."""
    ops = cluster_ops()
    t0 = time.perf_counter()
    result = {"phase": "plan_loop", "card": card, "models": MAIN_FLEET[0],
              "instances": MAIN_FLEET[1], "padded": list(TIER),
              "pods": PLAN_PODS}
    total = {}
    cluster = PlanCluster(ops, steady_records(*MAIN_FLEET), dev, PLAN_PODS)
    try:
        result["setup_s"] = cluster.setup_s
        emit({"phase": "plan_loop_setup", "setup_s": cluster.setup_s})
        ticks = []
        for k in range(PLAN_TICKS):
            ticks.append(plan_tick(dev, cluster))
            emit(dict(phase="plan_loop_tick", tick=k, **ticks[-1]))
            add_launches(total, ticks[-1]["launches"])
            check(ticks[-1]["solver_path"] == "sparse",
                  f"plan_loop: a tick took {ticks[-1]['solver_path']}")
        result["ticks"] = ticks
        result["profiled_tick"] = plan_tick(dev, cluster, profile=True)
        add_launches(total, result["profiled_tick"]["launches"])
        follower = next(p for p in cluster.pods
                        if not p.election.is_leader)
        records = cluster.last_records
        result["decisions"] = follower_decisions(
            ops, follower, records, PLAN_DECISIONS)
        result["shadow"] = shadow_agreement(ops, cluster, dev, records,
                                            PLAN_DECISIONS)
        result["truncation"] = plan_truncation(
            dev, cluster, ticks[-1]["plan_bytes"])
        add_launches(total, result["truncation"]["launches"])
        result["handover"] = plan_handover(dev, cluster)
        add_launches(total, result["handover"]["launches"])
    finally:
        cluster.close()
    dense = PlanCluster(ops, steady_records(*PLAN_DENSE_FLEET), dev, 1)
    try:
        tick = plan_tick(dev, dense)
        check(tick["solver_path"] == "dense"
              and tick["launches"].get("lse_sinkhorn_step", 0) > 0,
              f"plan_loop: the {PLAN_DENSE_FLEET} tick took "
              f"{tick['solver_path']} with launches {tick['launches']}")
        add_launches(total, tick["launches"])
        result["dense_tick"] = dict(tick, setup_s=dense.setup_s,
                                    fleet=list(PLAN_DENSE_FLEET))
    finally:
        dense.close()
    for key in ("scan_ms", "views_ms", "refresh_ms", "solve_ms",
                "publish_ms", "step_ms", "plan_bytes", "host_syncs"):
        result[key] = summary([t[key] for t in ticks])
    result["adopt_ms"] = summary([ms for t in ticks
                                  for ms in t["adopt_ms"].values()])
    result.update(launches_in_run=total,
                  seconds=time.perf_counter() - t0)
    check(result["seconds"] < PLAN_BUDGET_S,
          f"plan_loop took {result['seconds']:.1f} s, over "
          f"{PLAN_BUDGET_S} s")
    emit(result)
    return result


# -- phase instance: the serving instance on the card --------------------------

INST_PREFIX = "mm"
INST_PODS = 4
INST_MODELS = 256
INST_REQUESTS = 2000
INST_CLIENTS = 8
INST_ZIPF = 1.1
INST_BATCH_MAX = 8
# The fused burst: requests over models of one architecture resident on one
# pod, sent at once from the client threads, rounds until one fuses.
INST_BURST_MODELS = 4
INST_BURST_REQUESTS = 16
INST_BURST_ROUNDS = 5
# A pod holds 1/8 of the registry's bytes as built: the four hold half of
# it. (The loaders' size estimate, the reference's 2 bytes a parameter,
# counts f32 models at half and MoE experts not at all: 1/8 of the
# predicted bytes would hold a seventh of the registry.)
INST_CAPACITY_SHARE = 8
INST_SHUTDOWN_AT = 1000
# The middle leader step runs once this many requests have been taken, the
# client threads still sending.
INST_MIDDLE_AT = 500
INST_PROFILED = 200
INST_SEED = 1414
# Layer-streamable and larger than any pod's capacity (51 MB predicted
# against a pod's 40 MB): served as a group. Its tokens are the default
# transformer's (the same vocabulary and sequence).
INST_SHARDED = ("transformer", "transformer://d=1024,heads=8,layers=2")
INST_SHARDED_PAYLOAD = "transformer://"
# The phase is host-bound: the families draw their weights on the host
# (models/families.py), about 1.3 s a load under the traffic's threads. It
# took 116.9-178.1 s on an H100 host (the slowest with its reference
# answers drawn on 8 threads); the budget is 18% above the slowest.
INST_BUDGET_S = 210.0
INST_WAIT_S = 60.0


def instance_ops():
    """The serving instance's modules, imported where the phase needs them
    (tools/sparse_kernel_times.py imports this module against trees from
    before them)."""
    import types

    from modelmesh_tpu_torch.kv.memory import InMemoryKV
    from modelmesh_tpu_torch.models import families as tf
    from modelmesh_tpu_torch.models.server import (
        InProcessTorchLoader, TorchModelStore, predict_size_estimate,
    )
    from modelmesh_tpu_torch.observability.metrics import Metric, NoopMetrics
    from modelmesh_tpu_torch.observability.tracing import (
        SPAN_HEADER, TRACE_HEADER, Tracer, incoming_parent_span,
        incoming_trace_id,
    )
    from modelmesh_tpu_torch.placement import plan_sync
    from modelmesh_tpu_torch.placement.strategy import LOAD_HERE
    from modelmesh_tpu_torch.runtime.spi import ModelInfo
    from modelmesh_tpu_torch.serving.entry import EntryState
    from modelmesh_tpu_torch.serving.errors import ServiceUnavailableError
    from modelmesh_tpu_torch.serving.instance import (
        InstanceConfig, ModelMeshInstance, RoutingContext,
    )
    from modelmesh_tpu_torch.serving.tasks import reaper_plan_step

    return types.SimpleNamespace(**locals())


def counting_metrics(ops):
    """A metrics backend that keeps counts and observed values by metric
    (a NoopMetrics subclass, so the tracer and SLO tracker stay off the
    request path as with no backend)."""
    class CountingMetrics(ops.NoopMetrics):
        def __init__(self):
            self.lock = threading.Lock()
            self.counts: dict = {}
            self.values: dict = {}

        def inc(self, metric, value=1.0, model_id=""):
            with self.lock:
                self.counts[metric] = self.counts.get(metric, 0) + value

        def observe(self, metric, value_ms, model_id=""):
            with self.lock:
                self.values.setdefault(metric, []).append(float(value_ms))

    return CountingMetrics()


def pod_loader(ops, capacity: int, dev):
    """``InProcessTorchLoader`` on ``dev`` timing the store loads and
    counting any copy that landed off the card (a predict runs where its
    copy is)."""
    class PodLoader(ops.InProcessTorchLoader):
        def __init__(self):
            super().__init__(capacity_bytes=capacity, device=dev)
            self.lock = threading.Lock()
            self.off_card = 0
            self.load_ms: list = []

        def _on_card(self, loaded, ms=None):
            with self.lock:
                if loaded.handle.device.type != "cuda":
                    self.off_card += 1
                if ms is not None:
                    self.load_ms.append(ms)
            return loaded

        def load(self, model_id, info):
            t = time.perf_counter()
            out = super().load(model_id, info)
            return self._on_card(out, (time.perf_counter() - t) * 1e3)

        def load_from_stream(self, model_id, info, chunks,
                             partial_ready=None):
            return self._on_card(super().load_from_stream(
                model_id, info, chunks, partial_ready))

        def load_shard(self, model_id, info, shard_index, shard_count):
            return self._on_card(super().load_shard(
                model_id, info, shard_index, shard_count))

        def load_shard_from_stream(self, model_id, info, shard_index,
                                   shard_count, chunks):
            return self._on_card(super().load_shard_from_stream(
                model_id, info, shard_index, shard_count, chunks))

    return PodLoader()


class RequestLog(threading.local):
    """Per client thread, the routing events of the request in flight:
    ("decide", pod, model, answer, the plan's answer) for each load
    decision, answers resolved to pod ids, and ("failed", pod, model) for
    each load or forward to ``pod`` that gave up. Threads that send no
    client request (chains, pools, the leader) log nothing."""

    events = None

    def note(self, *event) -> None:
        if self.events is not None:
            self.events.append(event)


def plan_landings(events: list, served_by) -> list:
    """Each decision of one request where the plan had a usable target:
    (model, deciding pod, answer, the plan's answer, served_by, whether
    the answer's load or forward gave up). Where it did not give up, the
    request was served where the answer loaded the copy."""
    out = []
    for k, ev in enumerate(events):
        if ev[0] != "decide" or ev[4] in (None, "raced"):
            continue
        _, pod, mid, got, want = ev
        gave_up = ("failed", got, mid) in events[k + 1:]
        out.append((mid, pod, got, want, served_by, gave_up))
    return out


class InstanceTransport:
    """Direct-call peer transport between the pods, with the wire's trace
    handoff (the sim harness's _peer_call and _peer_fetch): the receiving
    pod re-opens the propagated trace in its own tracer."""

    def __init__(self, ops, log: RequestLog):
        self.ops = ops
        self.log = log
        self.pods: dict = {}

    def _pod(self, endpoint: str):
        pod = self.pods.get(endpoint)
        if pod is None or not pod.alive:
            raise self.ops.ServiceUnavailableError(endpoint)
        return pod

    def call(self, endpoint, model_id, method, payload, headers, ctx):
        try:
            return self._call(endpoint, model_id, method, payload, headers,
                              ctx)
        except Exception:
            self.log.note("failed", endpoint, model_id)
            raise

    def _call(self, endpoint, model_id, method, payload, headers, ctx):
        ops, pod = self.ops, self._pod(endpoint)
        headers = list(headers)
        tid = ops.incoming_trace_id(headers)
        parent = ops.incoming_parent_span(headers)
        if tid:
            headers = [(k, v) for k, v in headers
                       if k not in (ops.TRACE_HEADER, ops.SPAN_HEADER)]
        with (pod.inst.tracer.trace(tid, model_id, method or "",
                                    parent_span=parent)
              if tid else contextlib.nullcontext()):
            result = pod.inst.invoke_model(model_id, method, payload,
                                           headers, ctx, sync=True)
        result.feedback = pod.inst.load_feedback()
        return result

    def fetch(self, endpoint, model_id, chunk_index, fingerprint):
        ops, pod = self.ops, self._pod(endpoint)
        tid = ops.Tracer.current_trace_id() if chunk_index == 0 else ""
        if not tid:
            return pod.inst.handle_weight_fetch(model_id, chunk_index,
                                                fingerprint)
        with pod.inst.tracer.trace(
            tid, model_id, "FetchWeights",
            parent_span=ops.Tracer.current_span_id(),
        ), pod.inst.tracer.span("serve-chunk", chunk=chunk_index):
            return pod.inst.handle_weight_fetch(model_id, chunk_index,
                                                fingerprint)


class InstancePod:
    """One port ModelMeshInstance with its own loader on the card and a
    TorchPlacementStrategy on the card (greedy fallback), its load
    decisions logged beside the adopted plan's answer."""

    def __init__(self, ops, kv, idx: int, capacity: int, dev, transport):
        self.iid = f"pod-{idx}"
        self.alive = True
        self.loader = pod_loader(ops, capacity, dev)
        self.metrics = counting_metrics(ops)
        self.strategy = TorchPlacementStrategy(device=dev)
        self.decisions: list = []
        self._decisions_lock = threading.Lock()
        self._log_decisions(ops, transport.log)
        self.inst = ops.ModelMeshInstance(
            kv, self.loader,
            ops.InstanceConfig(
                instance_id=self.iid, endpoint=self.iid,
                kv_prefix=INST_PREFIX, load_timeout_s=120,
                min_churn_age_ms=0, batch_max=INST_BATCH_MAX,
                peer_fetch=True),
            strategy=self.strategy, peer_call=transport.call,
            peer_fetch=transport.fetch, metrics=self.metrics)
        self._log_local_loads(transport.log)
        transport.pods[self.iid] = self

    def _log_decisions(self, ops, log: RequestLog) -> None:
        """Each load decision: (model, answer, the plan's answer), answers
        resolved to pod ids; the plan's answer is None when the plan has no
        usable target, "raced" when a follower adopted another plan during
        the call."""
        strat = self.strategy
        choose = strat.choose_load_target

        def here(req, target):
            return (req.requesting_instance if target == ops.LOAD_HERE
                    else target)

        def logged(req, view):
            plan = strat.plan
            answer = choose(req, view)
            got = here(req, answer)
            want = None
            if strat.plan is not plan:
                want = "raced"
            elif plan is not None and plan.age_ms() <= strat.plan_ttl_ms:
                live = {iid for iid, _ in view.placeable()}
                want = next((iid for iid in plan.lookup(req.model_id) or ()
                             if iid not in req.exclude and iid in live
                             and iid not in req.model.instance_ids), None)
            with self._decisions_lock:
                self.decisions.append((req.model_id, got, want))
            log.note("decide", self.iid, req.model_id, got, want)
            return answer

        strat.choose_load_target = logged

    def _log_local_loads(self, log: RequestLog) -> None:
        """A local load that gave up (no room here, or it raised)."""
        load_local = self.inst._load_local

        def logged(model_id, mr, ctx):
            try:
                ce = load_local(model_id, mr, ctx)
            except Exception:
                log.note("failed", self.iid, model_id)
                raise
            if ce is None:
                log.note("failed", self.iid, model_id)
            return ce

        self.inst._load_local = logged

    def close(self) -> None:
        self.alive = False
        self.inst.shutdown()


def instance_registry(ops):
    """INST_MODELS seeded ids over MODEL_SPECS and MOE_SPECS in turn."""
    rng = np.random.default_rng(INST_SEED)
    specs = MODEL_SPECS + MOE_SPECS
    ids: list = []
    while len(ids) < INST_MODELS:
        mid = f"m-{int(rng.integers(0, 1 << 32)):08x}"
        if mid not in ids:
            ids.append(mid)
    return [(mid, specs[k % len(specs)]) for k, mid in enumerate(ids)]


def instance_payloads(ops, dev) -> tuple:
    """Per spec of MODEL_SPECS and MOE_SPECS: one seeded payload of one
    row, from the family's input shape and type, and the bytes a built
    model holds."""
    payloads, sizes, build_ms = {}, {}, {}
    for k, (mtype, path) in enumerate(MODEL_SPECS + MOE_SPECS):
        t = time.perf_counter()
        model = ops.tf.build_model("payload", mtype, path, device=dev)
        build_ms[path] = (time.perf_counter() - t) * 1e3
        payloads[path] = model_input(model, 1, INST_SEED + k).tobytes()
        sizes[path] = model.size_bytes
    emit({"phase": "instance_builds", "build_ms": build_ms})
    return payloads, sizes


def instance_requests(n_models: int) -> tuple:
    """INST_REQUESTS draws: Zipf(INST_ZIPF) over the models (rank to model
    through a seeded permutation), and a uniform entry draw."""
    rng = np.random.default_rng(INST_SEED + 1)
    ranks = np.arange(1, n_models + 1, dtype=np.float64)
    p = ranks ** -INST_ZIPF
    p /= p.sum()
    perm = rng.permutation(n_models)
    models = perm[rng.choice(n_models, size=INST_REQUESTS, p=p)]
    return models, rng.random(INST_REQUESTS)


def instance_traffic(ops, pods, registry, payloads, models, entries,
                     lo: int, hi: int, tag: str, log: RequestLog,
                     middle=None) -> list:
    """Requests ``lo``..``hi`` from INST_CLIENTS threads, each entering at
    a live pod (``entries`` picks one uniformly). Per request: the path
    (local hit, forwarded, miss with load, from the registry record the
    entry pod saw just before), latency, served_by, the answer or the
    error, and its plan decisions (plan_landings). ``middle``, if given,
    runs on this thread once INST_MIDDLE_AT requests have been taken,
    while the clients go on sending."""
    live = [p for p in pods if p.alive]
    out: list = [None] * (hi - lo)
    nxt = iter(range(lo, hi))
    taken = threading.Semaphore(0)
    lock = threading.Lock()

    def client():
        while True:
            with lock:
                k = next(nxt, None)
            if k is None:
                return
            taken.release()
            mid, (mtype, path) = registry[int(models[k])]
            pod = live[int(entries[k] * len(live))]
            rec = pod.inst.registry_view.get(mid)
            loaded = bool(rec is not None and rec.instance_ids)
            log.events = []
            t = time.perf_counter()
            try:
                res = pod.inst.invoke_model(mid, "predict", payloads[path],
                                            [])
                err = None
            except Exception as e:  # noqa: BLE001 — counted, fails the gate
                res, err = None, f"{type(e).__name__}: {e}"
            ms = (time.perf_counter() - t) * 1e3
            events, log.events = log.events, None
            if not loaded:
                path_kind = "miss_load"
            elif res is not None and res.served_by == pod.iid:
                path_kind = "local"
            else:
                path_kind = "forwarded"
            served_by = res.served_by if res else None
            out[k - lo] = {"k": k, "model": mid, "entry": pod.iid,
                           "path": path_kind, "tag": tag, "ms": ms,
                           "served_by": served_by,
                           "payload": res.payload if res else None,
                           "error": err,
                           "plan": plan_landings(events, served_by)}

    threads = [threading.Thread(target=client, name=f"client-{c}")
               for c in range(INST_CLIENTS)]
    for th in threads:
        th.start()
    try:
        if middle is not None:
            for _ in range(INST_MIDDLE_AT - lo):
                taken.acquire()
            middle()
    finally:
        for th in threads:
            th.join()
    return out


def instance_leader_step(ops, kv, pods, dev) -> dict:
    """The reaper's plan step on the elected pod, launch counters zeroed
    just before it; every live pod's follower adopts the published bytes."""
    live = [p for p in pods if p.alive]
    wait_until(lambda: sum(p.inst.is_leader for p in live) == 1,
               "one elected pod", INST_WAIT_S)
    leader = next(p for p in live if p.inst.is_leader)
    inst = leader.inst
    torch.cuda.synchronize(dev)
    reset_all_launches()
    t = time.perf_counter()
    step = ops.reaper_plan_step(kv, INST_PREFIX, leader.strategy,
                                inst.registry, inst.instances_view,
                                inst.model_rpm)
    step_ms = (time.perf_counter() - t) * 1e3
    launches = all_launches()
    check(step.plan is not None,
          f"instance: the leader's step failed: {step.error!r}")
    published = kv.get(ops.plan_sync.plan_key(INST_PREFIX))
    gen = step.plan.generation
    wait_until(lambda: all(p.strategy.plan is not None
                           and p.strategy.plan.generation == gen
                           for p in live),
               "every pod adopting the plan", INST_WAIT_S)
    for p in live:
        check(p.strategy.plan.to_bytes() == published.value,
              f"instance: {p.iid} adopted other bytes than published")
    for name in ("lse_sinkhorn_step", "row_lse_partial", "implied_load"):
        check(launches.get(name, 0) > 0,
              f"instance: the leader's step never launched {name} "
              f"({ {k: v for k, v in launches.items() if v} })")
    return {"leader": leader.iid, "generation": gen,
            "solver_path": step.plan.stats.get("solver_path"),
            "models": len(step.records), "instances": len(step.views),
            "plan_models": step.plan.num_models(),
            "plan_bytes": step.nbytes, "views_ms": step.views_ms,
            "scan_ms": step.scan_ms, "refresh_ms": step.refresh_ms,
            "solve_ms": step.plan.solve_ms, "publish_ms": step.publish_ms,
            "step_ms": step_ms,
            "launches": {k: v for k, v in launches.items() if v}}


def instance_sharded(ops, pods, payload: bytes, ref, dev) -> dict:
    """The oversized transformer: registered, invoked, placed as a group,
    its answer against the full model loaded on the reference store."""
    mtype, path = INST_SHARDED
    mid = "m-sharded"
    cap = max(p.inst.cache.capacity for p in pods)
    inst = pods[0].inst
    inst.register_model(mid, ops.ModelInfo(mtype, path))
    t = time.perf_counter()
    res = inst.invoke_model(mid, "predict", payload, [])
    ms = (time.perf_counter() - t) * 1e3
    mr = inst.registry.get(mid)
    check(mr is not None and mr.shard_count >= 2,
          f"instance: {mid} not placed as a group ({mr})")
    check(mr.size_units > cap,
          f"instance: {mid} ({mr.size_units} units) fits a pod ({cap})")
    ref.load(mid, mtype, path)
    want = np.frombuffer(ref.predict_batch([(mid, payload)])[0], np.float32)
    ref.unload(mid)
    got = np.frombuffer(res.payload, np.float32)
    check(got.shape == want.shape
          and np.allclose(got, want, **SERVING_TOL),
          f"instance: the sharded group's answer is off by "
          f"{float(np.abs(got - want).max())}")
    return {"model": mid, "spec": path, "shard_count": mr.shard_count,
            "members": dict(mr.shard_instances), "size_units": mr.size_units,
            "pod_capacity_units": cap, "served_by": res.served_by,
            "first_request_ms": ms,
            "max_abs_err": float(np.abs(got - want).max())}


def instance_fused_burst(ops, pods, registry, payloads) -> tuple:
    """INST_BURST_REQUESTS requests over up to INST_BURST_MODELS models of
    one architecture resident on one pod, from INST_CLIENTS threads
    released together: the requests that queue behind the first dispatch
    ride one batch, fused when its models differ. Rounds (at most
    INST_BURST_ROUNDS) until one fused; returns the summary and the rows."""
    specs = dict(registry)
    for pod in (p for p in pods if p.alive):
        groups: dict = {}
        for mid, ce, _ in pod.inst.cache.descending_items():
            key = pod.loader.batch_group_key(mid)
            if ce.state is ops.EntryState.ACTIVE and key.startswith("fuse:"):
                groups.setdefault(key, []).append(mid)
        mids = max(groups.values(), key=len, default=[])[:INST_BURST_MODELS]
        if len(mids) >= 2:
            break
    else:
        raise RuntimeError("chip_smoke: instance: no pod holds two models "
                           "of one architecture")
    store = pod.loader.store
    fused0 = store.fused_dispatches
    rows: list = []
    lock = threading.Lock()
    rounds = 0
    while rounds < INST_BURST_ROUNDS and store.fused_dispatches == fused0:
        rounds += 1
        todo = [mids[k % len(mids)] for k in range(INST_BURST_REQUESTS)]
        barrier = threading.Barrier(INST_CLIENTS)

        def client():
            barrier.wait()
            while True:
                with lock:
                    if not todo:
                        return
                    mid = todo.pop()
                t = time.perf_counter()
                try:
                    res = pod.inst.invoke_model(mid, "predict",
                                                payloads[specs[mid][1]], [])
                    err = None
                except Exception as e:  # noqa: BLE001 — fails the gate
                    res, err = None, f"{type(e).__name__}: {e}"
                with lock:
                    rows.append({"model": mid, "entry": pod.iid,
                                 "path": "local", "tag": "burst",
                                 "ms": (time.perf_counter() - t) * 1e3,
                                 "served_by": res.served_by if res else None,
                                 "payload": res.payload if res else None,
                                 "error": err, "plan": []})

        threads = [threading.Thread(target=client, name=f"burst-{c}")
                   for c in range(INST_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    check(len(rows) == INST_BURST_REQUESTS * rounds,
          f"instance: the fused burst answered {len(rows)} of "
          f"{INST_BURST_REQUESTS * rounds} requests")
    return {"pod": pod.iid, "models": mids, "rounds": rounds,
            "requests": len(rows),
            "fused_dispatches": store.fused_dispatches - fused0}, rows


def instance_stream(ops, pods, registry, ref) -> dict:
    """A second copy of a loaded transformer streamed from its holder into
    a live pod without it (a LOAD_LOCAL_ONLY hop): the copy's leaves byte
    for byte those of a store load."""
    live = [p for p in pods if p.alive]
    specs = dict(registry)
    for mid, (mtype, path) in registry:
        if mtype != "transformer" or "experts" in path:
            continue
        holders = [p for p in live
                   if (ce := p.inst.cache.get_quietly(mid)) is not None
                   and ce.state is ops.EntryState.ACTIVE]
        takers = [p for p in live if p not in holders
                  and p.inst.cache.get_quietly(mid) is None
                  and p.inst.host_tier.peek(mid) is None]
        if holders and takers:
            break
    else:
        raise RuntimeError("chip_smoke: instance: no loaded transformer to "
                           "stream")
    taker = takers[0]
    peer0 = taker.metrics.counts.get(ops.Metric.LOAD_FROM_PEER_COUNT, 0)
    t = time.perf_counter()
    taker.inst.invoke_model(
        mid, None, b"", [],
        ops.RoutingContext(hop=ops.RoutingContext.LOAD_LOCAL_ONLY),
        sync=True)
    ms = (time.perf_counter() - t) * 1e3
    peer = taker.metrics.counts.get(ops.Metric.LOAD_FROM_PEER_COUNT, 0)
    check(peer == peer0 + 1,
          f"instance: {mid}'s copy on {taker.iid} was not streamed from a "
          "peer")
    got = taker.loader.store.get(mid)
    mtype, path = specs[mid]
    ref.load(mid, mtype, path)
    want = ref.get(mid)
    same = ([ops.tf.leaf_bytes(t) for t in ops.tf.leaves(got.params)]
            == [ops.tf.leaf_bytes(t) for t in ops.tf.leaves(want.params)])
    ref.unload(mid)
    check(same, f"instance: {mid}'s streamed copy differs from a store load")
    return {"model": mid, "from": [p.iid for p in holders],
            "to": taker.iid, "ms": ms, "bitwise": same}


def instance_quiesce(ops, pods) -> dict:
    """Wait until no load is in flight and every live pod's cache agrees
    with the registry, then hold every record's instance_ids to the pods
    whose cache holds the model."""
    live = [p for p in pods if p.alive]
    resident = (ops.EntryState.ACTIVE, ops.EntryState.SHARDED)

    def mismatches():
        bad = []
        for mid, mr in live[0].inst.registry.items():
            holders = {p.iid for p in live
                       if (ce := p.inst.cache.get_quietly(mid)) is not None
                       and ce.state in resident}
            if set(mr.instance_ids) != holders or mr.loading_instances:
                bad.append((mid, sorted(mr.instance_ids), sorted(holders)))
        return bad

    t = time.perf_counter()
    try:
        wait_until(lambda: not mismatches(), "the registry settling",
                   INST_WAIT_S)
    except RuntimeError:
        check(False, f"instance: registry and caches disagree: "
              f"{mismatches()[:5]}")
    return {"settle_ms": (time.perf_counter() - t) * 1e3,
            "records": sum(1 for _ in live[0].inst.registry.items())}


def latency_by_path(rows) -> dict:
    out = {}
    for kind in ("local", "forwarded", "miss_load"):
        ms = [r["ms"] for r in rows if r["path"] == kind]
        out[kind] = ({"n": len(ms), "median_ms": float(np.median(ms)),
                      "p99_ms": float(np.percentile(ms, 99))}
                     if ms else {"n": 0})
    return out


def phase_instance(dev, card: str) -> dict:
    """The serving instance on the card (module docstring, phase 14)."""
    ops = instance_ops()
    t0 = time.perf_counter()
    stages: dict = {}
    last = [t0]

    def stage(name: str) -> None:
        now = time.perf_counter()
        stages[name] = now - last[0]
        last[0] = now
        emit({"phase": "instance_stage", "stage": name, "s": stages[name]})

    registry = instance_registry(ops)
    payloads, sizes = instance_payloads(ops, dev)
    predicted = sum(ops.predict_size_estimate(t, p) for _, (t, p) in registry)
    built = sum(sizes[p] for _, (_, p) in registry)
    capacity = built // INST_CAPACITY_SHARE
    result = {"phase": "instance", "card": card, "pods": INST_PODS,
              "models": len(registry), "requests": INST_REQUESTS,
              "clients": INST_CLIENTS, "zipf": INST_ZIPF,
              "batch_max": INST_BATCH_MAX, "registry_predicted_bytes":
              predicted, "registry_built_bytes": built,
              "pod_capacity_bytes": capacity}
    ref = ops.TorchModelStore(1 << 36, device=dev)
    kv = ops.InMemoryKV()
    log = RequestLog()
    transport = InstanceTransport(ops, log)
    pods: list = []
    launches: dict = {}
    try:
        for k in range(INST_PODS):
            pods.append(InstancePod(ops, kv, k, capacity, dev, transport))
        for p in pods:
            p.inst.instances_view.wait_for(
                lambda v: len(v) >= INST_PODS, timeout=INST_WAIT_S)
        for mid, (mtype, path) in registry:
            pods[0].inst.register_model(mid, ops.ModelInfo(mtype, path))
        for p in pods:
            wait_until(lambda p=p: len(p.inst.registry_view) >= len(registry),
                       f"{p.iid}'s view of the registry", INST_WAIT_S)
        result["setup_s"] = time.perf_counter() - t0
        stage("setup")
        steps = {}
        steps["before"] = instance_leader_step(ops, kv, pods, dev)
        add_launches(launches, steps["before"]["launches"])
        stage("leader_before")
        result["sharded"] = instance_sharded(
            ops, pods, payloads[INST_SHARDED_PAYLOAD], ref, dev)
        stage("sharded")
        models, entries = instance_requests(len(registry))

        def middle():
            # Launches counted while the step ran, the traffic's included.
            steps["middle"] = instance_leader_step(ops, kv, pods, dev)
            add_launches(launches, steps["middle"]["launches"])
            stage("traffic_to_middle")

        t = time.perf_counter()
        rows = instance_traffic(ops, pods, registry, payloads, models,
                                entries, 0, INST_SHUTDOWN_AT, "first", log,
                                middle)
        first_s = time.perf_counter() - t
        stage("traffic_first")
        # One pod drains (survivor pre-copy, host-tier demotion,
        # deregistration) and leaves; the traffic goes on against the rest.
        leaving = next(p for p in reversed(pods) if not p.inst.is_leader)
        t = time.perf_counter()
        leaving.inst.pre_shutdown()
        drain_ms = (time.perf_counter() - t) * 1e3
        leaving.close()
        stage("drain")
        from torch.profiler import ProfilerActivity, profile as profiler

        torch.cuda.synchronize(dev)
        lo, hi = INST_SHUTDOWN_AT, INST_SHUTDOWN_AT + INST_PROFILED
        with profiler(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            rows += instance_traffic(ops, pods, registry, payloads, models,
                                     entries, lo, hi, "after_shutdown", log)
            torch.cuda.synchronize(dev)
            window_ms = (time.perf_counter() - t) * 1e3
        by_name = device_ms_by_kernel(prof)
        busy = sum(ms for ms, _ in by_name.values())
        t = time.perf_counter()
        rows += instance_traffic(ops, pods, registry, payloads, models,
                                 entries, hi, INST_REQUESTS,
                                 "after_shutdown", log)
        second_s = window_ms / 1e3 + time.perf_counter() - t
        stage("traffic_after_shutdown")
        fused_traffic = sum(p.loader.store.fused_dispatches for p in pods)
        result["fused_burst"], burst_rows = instance_fused_burst(
            ops, pods, registry, payloads)
        rows += burst_rows
        stage("fused_burst")
        result["stream"] = instance_stream(ops, pods, registry, ref)
        stage("stream")
        result["quiesce"] = instance_quiesce(ops, pods)
        stage("quiesce")
        # Gates on the answers: every request answered, each answer the
        # reference store's predict of the same model and payload.
        errors = [r for r in rows if r["error"]]
        check(not errors, f"instance: {len(errors)} requests failed, first "
              f"{errors[:3]}")
        specs = dict(registry)

        def reference(mid):
            # One model at a time: the weights are drawn on the host, and
            # threads drawing at once take longer (on an H100 host, 42.6 s
            # on 8 threads against 24.1 s on one).
            mtype, path = specs[mid]
            ref.load(mid, mtype, path)
            try:
                return np.frombuffer(
                    ref.predict_batch([(mid, payloads[path])])[0],
                    np.float32)
            finally:
                ref.unload(mid)

        wants = {mid: reference(mid) for mid in {r["model"] for r in rows}}
        worst = {}
        for r in rows:
            mtype, path = specs[r["model"]]
            err = check_close(np.frombuffer(r["payload"], np.float32),
                              wants[r["model"]], MODEL_TOL[mtype],
                              f"instance: {r['model']} ({path}) via "
                              f"{r['entry']}")
            worst[path] = max(worst.get(path, 0.0), err)
        stage("answers")
        counts: dict = {}
        batch_sizes: list = []
        for p in pods:
            for metric, v in p.metrics.counts.items():
                counts[metric.name] = counts.get(metric.name, 0) + v
            batch_sizes += p.metrics.values.get(ops.Metric.BATCH_OCCUPANCY,
                                                [])
        load_ms = [ms for p in pods for ms in p.loader.load_ms]
        off_card = sum(p.loader.off_card for p in pods)
        fused = sum(p.loader.store.fused_dispatches for p in pods)
        decisions = [d for p in pods for d in p.decisions]
        # Each plan decision of a client request: the instance took the
        # plan's answer, and unless that load or forward gave up, the
        # request was served where the copy landed.
        landings = [d for r in rows for d in r["plan"]]
        wrong = [d for d in landings
                 if d[2] != d[3] or (not d[5] and d[4] != d[3])]
        check(not wrong, f"instance: {len(wrong)} of {len(landings)} plan "
              f"decisions did not land where the plan said "
              f"(model, pod, answer, plan, served_by, gave_up): {wrong[:5]}")
        check(counts.get("EVICT_COUNT", 0) > 0, "instance: no eviction")
        check(counts.get("INVOKE_FORWARD_COUNT", 0) > 0,
              "instance: no forward")
        check(fused > 0, "instance: no fused dispatch")
        check(off_card == 0,
              f"instance: {off_card} copies loaded off the card")
        result.update({
            "leader_steps": steps,
            "latency_first": latency_by_path(
                [r for r in rows if r["tag"] == "first"]),
            "latency_after_shutdown": dict(
                latency_by_path([r for r in rows
                                 if r["tag"] == "after_shutdown"]),
                all={"n": sum(r["tag"] == "after_shutdown" for r in rows),
                     "median_ms": float(np.median(
                         [r["ms"] for r in rows
                          if r["tag"] == "after_shutdown"])),
                     "p99_ms": float(np.percentile(
                         [r["ms"] for r in rows
                          if r["tag"] == "after_shutdown"], 99))}),
            "traffic_s": {"first": first_s, "after_shutdown": second_s},
            "drained": {"pod": leaving.iid, "ms": drain_ms},
            "load_ms": ({"n": len(load_ms),
                         "median": float(np.median(load_ms)),
                         "p99": float(np.percentile(load_ms, 99)),
                         "max": float(np.max(load_ms))}
                        if load_ms else None),
            "evictions": counts.get("EVICT_COUNT", 0),
            "forwards": counts.get("INVOKE_FORWARD_COUNT", 0),
            "load_sources": {k: counts.get(k, 0) for k in (
                "LOAD_FROM_STORE_COUNT", "LOAD_FROM_PEER_COUNT",
                "LOAD_FROM_HOST_TIER_COUNT", "HOST_TIER_DEMOTE_COUNT")},
            "batch_sizes": {str(int(s)): batch_sizes.count(s)
                            for s in sorted(set(batch_sizes))},
            "fused_dispatches": fused,
            "fused_dispatches_in_traffic": fused_traffic,
            "decisions": {
                "total": len(decisions),
                "plan": sum(1 for d in decisions
                            if d[2] not in (None, "raced")),
                "fallback": sum(1 for d in decisions if d[2] is None),
                "raced": sum(1 for d in decisions if d[2] == "raced"),
                "plan_in_requests": len(landings),
                "plan_gave_up": sum(1 for d in landings if d[5])},
            "max_err_by_spec": worst,
            "profiled": {"requests": INST_PROFILED, "window_ms": window_ms,
                         "device_busy_ms": busy,
                         "device_idle_share": 1.0 - busy / window_ms},
        })
    finally:
        for p in pods:
            if p.alive:
                p.close()
        kv.close()
        # The pools' workers leave once their queued unloads are done.
        t = time.perf_counter()
        while (any(p.inst._unload_pool.active_workers
                   or p.inst._cleanup_pool.active_workers for p in pods)
               and time.perf_counter() - t < INST_WAIT_S):
            time.sleep(0.01)
    result.update(launches_in_run=launches, stages_s=stages,
                  seconds=time.perf_counter() - t0)
    emit(result)
    check(result["seconds"] < INST_BUDGET_S,
          f"instance took {result['seconds']:.1f} s, over {INST_BUDGET_S} s")
    return result


SERVER_PREFIX = "mm"
SERVER_PODS = 3
# The Zipf traffic's models: SERVER_PER_SPEC of each spec of MODEL_SPECS
# but the autoscaled class's family, registered over gRPC.
SERVER_PER_SPEC = 4
SERVER_REQUESTS = (240, 120)    # before and after the drain
SERVER_VMODEL_REQUESTS = 12     # by vmodel id, before and after the rollover
SERVER_CLIENTS = 4
SERVER_ZIPF = 1.1
SERVER_SEED = 1515
# The class the phase burns by hand: its models (static, from
# register_static_models on the first pod) take no client traffic, so no
# request of the phase records into its SLO window; every other class has
# a bound no request reaches.
SERVER_BURN_CLASS = "linear"
SERVER_SLO = "linear:p99<50ms;default:p99<600000ms"
SERVER_STATIC = {"models": [
    {"modelId": f"m-lin-{k}", "type": "linear", "path": "linear://"}
    for k in range(2)]}
SERVER_VMODEL = ("vm-mlp", ("m-v1", "m-v2"), ("mlp", "mlp://"))
SERVER_SPLICER_MESSAGES = 200
# A pod's accelerated task cadences (the reference's 40 s publisher, 6 min
# janitor and 7 min reaper would not tick within the phase).
SERVER_TASKS = dict(publish_interval_s=1.0, rate_interval_s=10.0,
                    janitor_interval_s=2.0, reaper_interval_s=3.0,
                    autoscale_mode="burn", autoscale_interval_s=0.5)
SERVER_BUDGET_S = 150.0
SERVER_WAIT_S = 60.0


def server_ops():
    """The serving pod's modules, imported where the phase needs them."""
    import http.server
    import types

    import grpc

    from modelmesh_tpu_torch.autoscale.controller import AutoscaleConfig
    from modelmesh_tpu_torch.kv.memory import InMemoryKV
    from modelmesh_tpu_torch.models import families as tf
    from modelmesh_tpu_torch.models.server import (
        PREDICT_METHOD, InProcessTorchLoader, TorchModelStore,
        start_torch_runtime,
    )
    from modelmesh_tpu_torch.native import proto_splicer
    from modelmesh_tpu_torch.observability.payloads import build_processor
    from modelmesh_tpu_torch.placement import plan_sync
    from modelmesh_tpu_torch.proto import mesh_api_pb2 as apb
    from modelmesh_tpu_torch.runtime import grpc_defs
    from modelmesh_tpu_torch.runtime.sidecar import SidecarRuntime
    from modelmesh_tpu_torch.serving import tasks as tasks_mod
    from modelmesh_tpu_torch.serving.api import (
        MeshServer, PeerChannels, make_grpc_peer_call, make_grpc_peer_fetch,
    )
    from modelmesh_tpu_torch.serving.bootstrap import (
        PreStopServer, register_static_models,
    )
    from modelmesh_tpu_torch.serving.constraints import UpgradeTracker
    from modelmesh_tpu_torch.serving.dynamic import ServingConfigBinder
    from modelmesh_tpu_torch.serving.entry import EntryState
    from modelmesh_tpu_torch.serving.health import BootstrapProbation
    from modelmesh_tpu_torch.serving.instance import (
        InstanceConfig, ModelMeshInstance,
    )
    from modelmesh_tpu_torch.serving.tasks import BackgroundTasks, TaskConfig
    from modelmesh_tpu_torch.serving.vmodels import VModelManager

    return types.SimpleNamespace(**locals())


class PayloadSink:
    """The pods' payload processor's remote end: an HTTP server on
    localhost keeping (kind, model, status) of every payload posted."""

    def __init__(self, ops):
        self.lock = threading.Lock()
        self.got: list = []
        sink = self

        class Handler(ops.http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 — stdlib API
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n))
                with sink.lock:
                    sink.got.append((body["kind"], body["modelid"],
                                     body["status"]))
                self.send_response(200)
                self.end_headers()
                self.wfile.write(b"ok")

            def log_message(self, *args):
                pass

        self.server = ops.http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                          Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/p"
        threading.Thread(target=self.server.serve_forever, daemon=True,
                         name="payload-sink").start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


class ServerPod:
    """One pod as the reference launcher wires it (``serving/main.py``):
    a port ModelMeshInstance with its loader on the card (in process, or
    the sidecar runtime in front of ``start_torch_runtime``), a
    TorchPlacementStrategy on the card, bootstrap probation and the
    upgrade tracker, peers over gRPC through the shared channels, a
    MeshServer with vmodels and the payload processor, background tasks
    in burn mode, the dynamic config binder and the preStop server."""

    def __init__(self, ops, kv, idx: int, capacity: int, dev, channels,
                 sink_url: str, sidecar: bool):
        self.iid = f"srv-{idx}"
        self.alive = True
        self.runtime_server = None
        self.removals: list = []
        if sidecar:
            self.runtime_server, port, _ = ops.start_torch_runtime(
                capacity_bytes=capacity, device=dev)
            self.loader = ops.SidecarRuntime(f"127.0.0.1:{port}",
                                             startup_timeout_s=60)
        else:
            self.loader = ops.InProcessTorchLoader(capacity_bytes=capacity,
                                                   device=dev)
        self.strategy = TorchPlacementStrategy(device=dev)
        self.inst = ops.ModelMeshInstance(
            kv, self.loader,
            ops.InstanceConfig(instance_id=self.iid, kv_prefix=SERVER_PREFIX,
                               load_timeout_s=120, min_churn_age_ms=0,
                               batch_max=8, slo_spec=SERVER_SLO),
            strategy=self.strategy,
            peer_call=ops.make_grpc_peer_call(channels, timeout_s=60.0),
            peer_fetch=ops.make_grpc_peer_fetch(channels, timeout_s=60.0),
            upgrade_tracker=ops.UpgradeTracker(),
            probation=ops.BootstrapProbation.from_env())
        self._record_removals()
        self.vmodels = ops.VModelManager(self.inst)
        self.server = ops.MeshServer(
            self.inst, port=0, vmodels=self.vmodels,
            payload_processor=ops.build_processor([sink_url]))
        self.inst.config.endpoint = self.server.endpoint
        self.inst.publish_instance_record(force=True)
        self.tasks = ops.BackgroundTasks(self.inst, ops.TaskConfig(
            autoscale=ops.AutoscaleConfig(min_burn_samples=3, prewarm=False),
            **SERVER_TASKS))
        self.tasks.start()
        self.binder = ops.ServingConfigBinder(kv, self.inst.config.kv_prefix,
                                              self.inst, self.tasks.config)
        self.prestop = ops.PreStopServer(self.inst, port=0,
                                         max_wait_s=SERVER_WAIT_S)
        self.channel = ops.grpc.insecure_channel(self.server.endpoint)

    def _record_removals(self) -> None:
        """(model, thread) of each local copy removed on purpose."""
        remove = self.inst._remove_local

        def logged(model_id, *args, **kwargs):
            out = remove(model_id, *args, **kwargs)
            if out:
                self.removals.append((model_id,
                                      threading.current_thread().name))
            return out

        self.inst._remove_local = logged

    def holds(self, ops, mid: str) -> bool:
        ce = self.inst.cache.get_quietly(mid)
        return ce is not None and ce.state is ops.EntryState.ACTIVE

    def http(self, path: str) -> tuple:
        import urllib.error
        import urllib.request

        url = f"http://127.0.0.1:{self.prestop.port}{path}"
        try:
            r = urllib.request.urlopen(url, timeout=SERVER_WAIT_S + 30)
            return r.status, r.read().decode().strip()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode().strip()

    def close(self) -> None:
        if not self.alive:
            return
        self.alive = False
        self.tasks.stop()
        self.binder.close()
        self.channel.close()
        self.server.stop(0)
        self.vmodels.close()
        self.prestop.close()
        self.inst.shutdown()
        if self.runtime_server is not None:
            self.runtime_server.stop(0)


def server_call(ops, pod, mid: str, payload: bytes, vmodel=False) -> dict:
    """One Predict through ``pod``'s public gRPC surface, the model (or
    vmodel) id in the header."""
    header = (ops.grpc_defs.VMODEL_ID_HEADER if vmodel
              else ops.grpc_defs.MODEL_ID_HEADER)
    call = ops.grpc_defs.raw_method(pod.channel, ops.PREDICT_METHOD)
    t = time.perf_counter()
    try:
        out, c = call.with_call(payload, metadata=[(header, mid)],
                                timeout=SERVER_WAIT_S * 2)
        served_by = dict(c.trailing_metadata()).get("mm-served-by")
        err = None
    except ops.grpc.RpcError as e:
        out, served_by, err = None, None, f"{e.code().name}: {e.details()}"
    return {"model": mid, "vmodel": vmodel, "entry": pod.iid,
            "served_by": served_by, "payload": out, "error": err,
            "ms": (time.perf_counter() - t) * 1e3}


def server_traffic(ops, pods, models, payloads, n: int, seed: int) -> list:
    """``n`` Zipf(SERVER_ZIPF) requests over ``models`` from
    SERVER_CLIENTS threads, each entering at a uniformly drawn live
    pod."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, len(models) + 1, dtype=np.float64)
    p = ranks ** -SERVER_ZIPF
    p /= p.sum()
    perm = rng.permutation(len(models))
    picks = perm[rng.choice(len(models), size=n, p=p)]
    entries = rng.random(n)
    live = [q for q in pods if q.alive]
    out: list = [None] * n
    nxt = iter(range(n))
    lock = threading.Lock()

    def client():
        while True:
            with lock:
                k = next(nxt, None)
            if k is None:
                return
            mid, (_, path) = models[int(picks[k])]
            pod = live[int(entries[k] * len(live))]
            out[k] = server_call(ops, pod, mid, payloads[path])

    threads = [threading.Thread(target=client, name=f"srv-client-{c}")
               for c in range(SERVER_CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return out


def check_answers(ref, rows, specs_by_id, payloads, what: str) -> dict:
    """Every row (``server_call``'s) answered, each within MODEL_TOL of
    ``ref``'s predict of its model (a vmodel row's target); the worst
    error by spec."""
    errors = [r for r in rows if r["error"]]
    check(not errors, f"{what}: {len(errors)} requests failed, first "
          f"{errors[:3]}")
    wants, worst = {}, {}
    for r in rows:
        mid = r.get("target", r["model"])
        mtype, path = specs_by_id[mid]
        if mid not in wants:
            ref.load(mid, mtype, path)
            wants[mid] = np.frombuffer(
                ref.predict_batch([(mid, payloads[path])])[0], np.float32)
            ref.unload(mid)
        err = check_close(np.frombuffer(r["payload"], np.float32),
                          wants[mid], MODEL_TOL[mtype],
                          f"{what}: {mid} via {r['entry']}")
        worst[path] = max(worst.get(path, 0.0), err)
    return worst


def server_leader(pods):
    live = [p for p in pods if p.alive]
    wait_until(lambda: sum(p.inst.is_leader for p in live) == 1,
               "one elected pod", SERVER_WAIT_S)
    return next(p for p in live if p.inst.is_leader)


def splicer_gate(ops) -> dict:
    """The native splicer (built with g++ at first use) against its
    Python path on seeded messages: every field path's location and
    every splice, byte for byte."""
    ps = ops.proto_splicer
    t = time.perf_counter()
    check(ps._ensure_native(), "server: the native splicer did not build")
    build_ms = (time.perf_counter() - t) * 1e3
    rng = np.random.default_rng(SERVER_SEED)
    apb = ops.apb

    def text(n):
        return "".join(chr(int(c)) for c in rng.integers(97, 123, size=n))

    compared = 0
    for _ in range(SERVER_SPLICER_MESSAGES):
        msg = apb.RegisterModelRequest(
            model_id=text(int(rng.choice([0, 3, 127, 128, 300]))),
            info=apb.ModelInfo(model_type=text(int(rng.integers(0, 200))),
                               model_path=text(int(rng.integers(0, 20)))),
            load_now=bool(rng.integers(0, 2)))
        data = msg.SerializeToString()
        for path in ((1,), (2, 1), (2, 2), (2, 3), (4,), (9,)):
            native = ps._find_path(data, path)
            check(native == ps._find_path_py(data, path),
                  f"server: splicer paths differ at {path}")
            if native is not None:
                new = text(int(rng.integers(0, 200)))
                got = ps.splice_id(data, path, new)
                lib = ps._lib
                ps._lib = False
                try:
                    want = ps.splice_id(data, path, new)
                finally:
                    ps._lib = lib
                check(got == want, f"server: splices differ at {path}")
            compared += 1
    return {"backend": ps.backend, "build_ms": build_ms,
            "messages": SERVER_SPLICER_MESSAGES, "paths": compared}


def phase_server(dev, card: str) -> dict:
    """The serving pods over gRPC on the card (module docstring, phase
    15)."""
    ops = server_ops()
    t0 = time.perf_counter()
    stages: dict = {}
    last = [t0]

    def stage(name: str) -> None:
        now = time.perf_counter()
        stages[name] = now - last[0]
        last[0] = now
        emit({"phase": "server_stage", "stage": name, "s": stages[name]})

    specs = [s for s in MODEL_SPECS if s[0] != SERVER_BURN_CLASS]
    models = [(f"m-{k}-{j}", spec) for k, spec in enumerate(specs)
              for j in range(SERVER_PER_SPEC)]
    vm_id, vm_targets, vm_spec = SERVER_VMODEL
    specs_by_id = dict(models)
    specs_by_id.update({m["modelId"]: (m["type"], m["path"])
                        for m in SERVER_STATIC["models"]})
    specs_by_id.update({t: vm_spec for t in vm_targets})
    payloads, built = {}, 0
    for k, (mtype, path) in enumerate(MODEL_SPECS):
        model = ops.tf.build_model("payload", mtype, path, device=dev)
        payloads[path] = model_input(model, 1, SERVER_SEED + k).tobytes()
        built += model.size_bytes * (SERVER_PER_SPEC + 2)
    # Every pod could hold the whole registry: the phase measures the
    # surfaces, not eviction (phase instance's).
    capacity = built
    result = {"phase": "server", "card": card, "pods": SERVER_PODS,
              "models": len(models), "clients": SERVER_CLIENTS,
              "zipf": SERVER_ZIPF, "pod_capacity_bytes": capacity,
              "tasks": SERVER_TASKS}
    ref = ops.TorchModelStore(1 << 36, device=dev)
    kv = ops.InMemoryKV()
    channels = ops.PeerChannels()
    sink = PayloadSink(ops)
    pods: list = []
    ticks: list = []
    real_step = ops.tasks_mod.reaper_plan_step

    def recorded_step(store, kv_prefix, strategy, registry, view,
                      rpm_fn=None):
        """The leader's reaper step as BackgroundTasks calls it, with the
        launches it made and every live pod's adoption of its bytes."""
        before = all_launches()
        step = real_step(store, kv_prefix, strategy, registry, view, rpm_fn)
        after = all_launches()
        rec = {"pod": next((p.iid for p in pods if p.strategy is strategy),
                           None),
               "published": step.plan is not None,
               "error": repr(step.error) if step.error else None,
               "records": len(step.records), "views": len(step.views),
               "scan_ms": step.scan_ms, "refresh_ms": step.refresh_ms,
               "publish_ms": step.publish_ms, "nbytes": step.nbytes,
               "launches": {k: after[k] - before.get(k, 0) for k in after
                            if after[k] != before.get(k, 0)}}
        if step.plan is not None:
            gen = step.plan.generation
            rec["generation"] = gen
            rec["solver_path"] = step.plan.stats.get("solver_path")
            published = store.get(ops.plan_sync.plan_key(kv_prefix)).value
            live = [p for p in pods if p.alive]
            t = time.perf_counter()
            try:
                wait_until(lambda: all(p.strategy.plan is not None
                                       and p.strategy.plan.generation >= gen
                                       for p in live), "adoption", 10.0)
                rec["adopted"] = all(
                    p.strategy.plan.generation != gen
                    or p.strategy.plan.to_bytes() == published
                    for p in live)
                rec["adopt_ms"] = (time.perf_counter() - t) * 1e3
            except RuntimeError:
                rec["adopted"] = False
        ticks.append(rec)
        return step

    ops.tasks_mod.reaper_plan_step = recorded_step
    try:
        for k in range(SERVER_PODS):
            pods.append(ServerPod(ops, kv, k, capacity, dev, channels,
                                  sink.url, sidecar=k == SERVER_PODS - 1))
        for p in pods:
            p.inst.instances_view.wait_for(lambda v: len(v) >= SERVER_PODS,
                                           timeout=SERVER_WAIT_S)
        # The static models: the first pod's register_static_models, as
        # the launcher calls it (the other pods' knob is unset: none).
        static = ops.register_static_models(
            pods[0].inst, pods[0].vmodels,
            config_json=json.dumps(SERVER_STATIC))
        check(static == [m["modelId"] for m in SERVER_STATIC["models"]],
              f"server: static registration gave {static}")
        for p in pods[1:]:
            check(ops.register_static_models(p.inst, p.vmodels) == [],
                  "server: a pod without static models registered some")
        api = [ops.grpc_defs.make_stub(p.channel, ops.grpc_defs.API_SERVICE,
                                       ops.grpc_defs.API_METHODS)
               for p in pods]
        for k, (mid, (mtype, path)) in enumerate(models):
            st = api[k % len(api)].RegisterModel(ops.apb.RegisterModelRequest(
                model_id=mid, info=ops.apb.ModelInfo(model_type=mtype,
                                                     model_path=path)),
                timeout=SERVER_WAIT_S)
            check(st.model_id == mid, f"server: RegisterModel {mid}: {st}")
        n_registered = len(models) + len(static)
        for p in pods:
            wait_until(lambda p=p: len(p.inst.registry_view) >= n_registered,
                       f"{p.iid}'s view of the registry", SERVER_WAIT_S)
        result["setup_s"] = time.perf_counter() - t0
        stage("setup")
        reset_all_launches()
        ticks.clear()
        # Status and EnsureLoaded over gRPC.
        statuses = {}
        for k, m in enumerate(SERVER_STATIC["models"]):
            st = api[(k + 1) % len(api)].EnsureLoaded(
                ops.apb.EnsureLoadedRequest(model_id=m["modelId"], sync=True),
                timeout=SERVER_WAIT_S * 2)
            check(st.status == ops.apb.LOADED,
                  f"server: EnsureLoaded {m['modelId']}: {st}")
        for mid, _ in models[:3] + [("m-none", None)]:
            st = api[1].GetModelStatus(
                ops.apb.GetModelStatusRequest(model_id=mid),
                timeout=SERVER_WAIT_S)
            statuses[mid] = (ops.apb.ModelStatus.Name(st.status),
                             st.copy_count)
        check(statuses["m-none"][0] == "NOT_FOUND",
              f"server: status of an unregistered model: {statuses}")
        result["statuses"] = statuses
        stage("api")
        rows = server_traffic(ops, pods, models, payloads,
                              SERVER_REQUESTS[0], SERVER_SEED + 1)
        stage("traffic_first")
        # A vmodel and its rollover: the alias answers from its target.
        vm_rows, vm_active = [], []
        for target in vm_targets:
            st = api[0].SetVModel(ops.apb.SetVModelRequest(
                vmodel_id=vm_id, target_model_id=target,
                info=ops.apb.ModelInfo(model_type=vm_spec[0],
                                       model_path=vm_spec[1]),
                auto_delete_target=True, load_now=True, sync=True),
                timeout=SERVER_WAIT_S * 2)
            got = api[1].GetVModelStatus(ops.apb.GetVModelStatusRequest(
                vmodel_id=vm_id), timeout=SERVER_WAIT_S)
            vm_active.append((st.active_model_id, got.active_model_id,
                              ops.apb.VModelStatusInfo.TransitionStatus.Name(
                                  got.transition)))
            check(got.active_model_id == target,
                  f"server: {vm_id} active {got.active_model_id}, "
                  f"not {target}")
            for k in range(SERVER_VMODEL_REQUESTS):
                row = server_call(ops, pods[k % len(pods)], vm_id,
                                  payloads[vm_spec[1]], vmodel=True)
                row["target"] = target
                vm_rows.append(row)
        result["vmodel"] = {"id": vm_id, "active": vm_active}
        stage("vmodels")
        # The autoscaler: a burn injected into the leader's SLO window on
        # one class; its controller adds a copy of the class's models.
        leader = server_leader(pods)
        burn_models = [m["modelId"] for m in SERVER_STATIC["models"]]
        copies0 = {mid: leader.inst.registry.get(mid).copy_count
                   for mid in burn_models}
        for _ in range(6):
            leader.inst.slo.record(SERVER_BURN_CLASS, 5_000.0, True)
        asc = leader.tasks.autoscaler

        def scaled():
            ups = [d for d in list(asc.decisions)
                   if d["kind"] == "autoscale-up"]
            return ups and any(
                leader.inst.registry.get(d["model"]).copy_count
                > copies0[d["model"]] for d in ups)

        t = time.perf_counter()
        wait_until(scaled, "an autoscale-up that added a copy",
                   SERVER_WAIT_S)
        ups = [d for d in list(asc.decisions) if d["kind"] == "autoscale-up"]
        result["autoscale"] = {
            "leader": leader.iid, "ms": (time.perf_counter() - t) * 1e3,
            "ups": ups, "copies_before": copies0,
            "copies_after": {mid: leader.inst.registry.get(mid).copy_count
                             for mid in burn_models}}
        check(all(d["slo_class"] == SERVER_BURN_CLASS for d in ups),
              f"server: autoscale-up outside the burnt class: {ups}")
        stage("autoscale")
        # UnregisterModel at a pod that does not hold the model; its holder
        # drops the copy (the deletion watch). Then the same with the
        # holder's watch listener detached, as if it missed the event: its
        # janitor drops the copy.
        def single_copy(exclude=()):
            for mid, _ in models:
                mr = leader.inst.registry.get(mid)
                if (mr is not None and len(mr.instance_ids) == 1
                        and mid not in exclude):
                    holder = next(p for p in pods
                                  if p.iid in mr.instance_ids)
                    if holder.holds(ops, mid):
                        return mid, holder
            raise RuntimeError("chip_smoke: server: no model with one copy")

        unreg = {}
        for how in ("watch", "janitor"):
            mid, holder = single_copy(exclude=[u["model"]
                                               for u in unreg.values()])
            other = next(p for p in pods if p is not holder)
            listeners = holder.inst.registry_view._listeners
            listener = holder.inst._on_registry_event
            if how == "janitor":
                listeners.remove(listener)
            try:
                t = time.perf_counter()
                api[pods.index(other)].UnregisterModel(
                    ops.apb.UnregisterModelRequest(model_id=mid),
                    timeout=SERVER_WAIT_S)
                wait_until(lambda: any(m == mid for m, _ in holder.removals),
                           f"{holder.iid} dropping {mid}", SERVER_WAIT_S)
                ms = (time.perf_counter() - t) * 1e3
            finally:
                if how == "janitor":
                    listeners.append(listener)
            by = [th for m, th in holder.removals if m == mid]
            unreg[how] = {"model": mid, "holder": holder.iid,
                          "at": other.iid, "ms": ms, "removed_by": by}
            if how == "janitor":
                check(by and by[-1].startswith("task-janitor-"),
                      f"server: {mid}'s copy was not dropped by the "
                      f"janitor ({by})")
        models = [m for m in models
                  if m[0] not in {u["model"] for u in unreg.values()}]
        result["unregister"] = unreg
        stage("unregister")
        # One pod drains through its preStop hook; /ready flips.
        leader = server_leader(pods)
        drained = next(p for p in reversed(pods) if p is not leader)
        held = [mid for mid, _ in models if drained.holds(ops, mid)]
        t = time.perf_counter()
        hook = drained.http("/prestop")
        drain_ms = (time.perf_counter() - t) * 1e3
        ready = drained.http("/ready")
        check(hook == (200, "migrated"), f"server: /prestop gave {hook}")
        check(ready[0] == 503, f"server: /ready after the drain: {ready}")
        drained.close()
        result["drain"] = {"pod": drained.iid, "ms": drain_ms,
                           "held": held, "ready_after": ready}
        stage("drain")
        rows += server_traffic(ops, pods, models, payloads,
                               SERVER_REQUESTS[1], SERVER_SEED + 2)
        survivors = [p for p in pods if p.alive]
        moved = [server_call(ops, survivors[k % len(survivors)], mid,
                             payloads[specs_by_id[mid][1]])
                 for k, mid in enumerate(held)]
        for r in moved:
            check(r["error"] is None and r["served_by"] != drained.iid,
                  f"server: {r['model']} after the drain: {r}")
        rows += moved
        stage("traffic_after_drain")
        result["splicer"] = splicer_gate(ops)
        stage("splicer")
        # Quiescence: no load in flight; every record's holders are the
        # live pods whose cache holds the model.
        live = [p for p in pods if p.alive]

        def mismatches():
            bad = []
            for mid, mr in live[0].inst.registry.items():
                holders = {p.iid for p in live if p.holds(ops, mid)}
                if set(mr.instance_ids) != holders or mr.loading_instances:
                    bad.append((mid, sorted(mr.instance_ids),
                                sorted(holders)))
            return bad

        try:
            wait_until(lambda: not mismatches(), "the registry settling",
                       SERVER_WAIT_S)
        except RuntimeError:
            check(False, f"server: registry and caches disagree: "
                  f"{mismatches()[:5]}")
        result["quiesce"] = {"records": sum(
            1 for _ in live[0].inst.registry.items())}
        stage("quiesce")
        # The answers: each the reference store's predict of its model.
        worst = check_answers(ref, rows + vm_rows, specs_by_id, payloads,
                              "server")
        stage("answers")
        # The reaper's ticks: at least two of the leader's published a
        # plan, every one adopted by every live pod, byte for byte.
        try:
            wait_until(lambda: sum(r["published"] for r in ticks) >= 2,
                       "two published reaper ticks", SERVER_WAIT_S)
        except RuntimeError:
            pass
        launches = {k: v for k, v in all_launches().items() if v}
        published = [r for r in ticks if r["published"]]
        check(len(published) >= 2,
              f"server: {len(published)} reaper ticks published a plan")
        check(all(r["adopted"] for r in published),
              f"server: a published plan not adopted: "
              f"{[r for r in published if not r['adopted']][:2]}")
        for name in ("lse_sinkhorn_step", "row_lse_partial", "implied_load"):
            check(launches.get(name, 0) > 0,
                  f"server: the leader's ticks never launched {name} "
                  f"({launches})")
        # The payload sink: a request and a response for every call.
        calls = rows + vm_rows
        with sink.lock:
            got = list(sink.got)
        kinds = {k: sum(1 for g in got if g[0] == k)
                 for k in ("request", "response")}
        check(kinds["request"] == len(calls)
              and kinds["response"] == len(calls),
              f"server: the payload sink got {kinds} for {len(calls)} "
              f"calls")
        ms = [r["ms"] for r in rows]
        result.update({
            "requests": len(rows), "vmodel_requests": len(vm_rows),
            "latency_ms": {"median": float(np.median(ms)),
                           "p99": float(np.percentile(ms, 99)),
                           "max": float(np.max(ms))},
            "served_by": {p.iid: sum(r["served_by"] == p.iid for r in rows)
                          for p in pods},
            "max_err_by_spec": worst,
            "payloads": kinds,
            "reaper_ticks": len(ticks), "published_ticks": len(published),
            "ticks": published[:4],
            "task_ticks": {p.iid: {n: len(v) for n, v in
                                   p.tasks.tick_times.items()}
                           for p in pods},
        })
    finally:
        ops.tasks_mod.reaper_plan_step = real_step
        for p in pods:
            p.close()
        channels.close()
        sink.close()
        kv.close()
    result.update(launches_in_run=launches, stages_s=stages,
                  seconds=time.perf_counter() - t0)
    emit(result)
    check(result["seconds"] < SERVER_BUDGET_S,
          f"server took {result['seconds']:.1f} s, over {SERVER_BUDGET_S} s")
    return result


# -- phase cluster: launcher pods as separate processes ------------------------

CLUSTER_PREFIX = "mm"   # the launcher's kv prefix (InstanceConfig default)
CLUSTER_PODS = 3
# The registry: CLUSTER_PER_SPEC models of each MODEL_SPECS spec over
# gRPC, and SERVER_STATIC's models through the first pod's
# MM_STATIC_MODELS (the launcher's register_static_models).
CLUSTER_PER_SPEC = 3
CLUSTER_REQUESTS = 300          # Zipf(SERVER_ZIPF) from SERVER_CLIENTS threads
CLUSTER_DRAIN_REQUESTS = 120    # at the survivors while one pod drains
CLUSTER_SEED = 1616
# The short passes on the other two coordination protocols.
CLUSTER_SCHEMES = ("etcd", "zookeeper")
CLUSTER_SCHEME_PODS = 2
CLUSTER_SCHEME_MODELS = 3
CLUSTER_SCHEME_REQUESTS = 30
# A pod's accelerated cadences (the launcher's BackgroundTasks defaults are
# the reference's 40 s publisher, 6 min janitor and 7 min reaper).
CLUSTER_TASKS = dict(publish_interval_s=1.0, janitor_interval_s=2.0,
                     reaper_interval_s=3.0)
CLUSTER_BUDGET_S = 150.0
CLUSTER_START_S = 120.0         # spawn to READY, per pod
CLUSTER_WAIT_S = 60.0
# The KV servers' gRPC worker threads: each watch stream holds one for its
# life, and a launcher pod keeps several open (the servers' default of 16
# leaves a third pod's unary calls queued past their deadline).
CLUSTER_KV_WORKERS = 64
# The card's used memory must rise by at least this much a pod while the
# pods hold their copies (a CUDA context alone takes more).
CLUSTER_POD_MIN_MIB = 256
# How long after a reaper tick a live pod may take to adopt its plan (a
# pod stopped sooner is not held to it).
CLUSTER_ADOPT_S = 2.0
CLUSTER_POD_CODE = ("import sys, chip_smoke as cs; "
                    "sys.exit(cs.cluster_pod(sys.argv[1:]))")
# Launcher arguments every pod gets beyond the phase's own. Empty on the
# card: the pods take the launcher's default device, cuda:0. A rehearsal
# on the host sets ("--device", "cpu").
CLUSTER_POD_ARGS: tuple = ()


def _digest(data: bytes) -> str:
    import hashlib

    return hashlib.sha256(data).hexdigest()[:16]


def cluster_pod(argv) -> int:
    """One pod of phase cluster, in a child process: the launcher's
    ``main(argv)`` (``modelmesh_tpu_torch/serving/main.py``) with the
    phase's task cadences (CLUSTER_TASKS), recording each reaper step its
    BackgroundTasks take (launches, the published plan's generation and
    digest) and each plan its strategy holds. After ``main`` returns on
    SIGTERM it prints one JSON line: the pod's launch counters, its
    devices and peak device memory, its ticks and plans. Run as
    ``python3 -c "$CLUSTER_POD_CODE" <launcher arguments>``. A fatal
    signal dumps every thread's stack to stderr."""
    import faulthandler

    from modelmesh_tpu_torch.models import server as model_server
    from modelmesh_tpu_torch.placement import plan_sync, torch_engine
    from modelmesh_tpu_torch.serving import main as launcher
    from modelmesh_tpu_torch.serving import tasks as tasks_mod

    stores, strategies, ticks, plans = [], [], [], []

    def captured(cls, into):
        real = cls.__init__

        def init(self, *args, **kwargs):
            real(self, *args, **kwargs)
            into.append(self)
        cls.__init__ = init

    captured(model_server.TorchModelStore, stores)
    captured(torch_engine.TorchPlacementStrategy, strategies)
    real_tasks = tasks_mod.BackgroundTasks.__init__

    def tasks_init(self, instance, config=None):
        real_tasks(self, instance,
                   config or tasks_mod.TaskConfig(**CLUSTER_TASKS))
    tasks_mod.BackgroundTasks.__init__ = tasks_init
    real_step = tasks_mod.reaper_plan_step

    def recorded_step(store, kv_prefix, strategy, registry, view,
                      rpm_fn=None):
        before = all_launches()
        step = real_step(store, kv_prefix, strategy, registry, view, rpm_fn)
        after = all_launches()
        rec = {"t": time.time(), "published": step.plan is not None,
               "error": repr(step.error) if step.error else None,
               "records": len(step.records), "views": len(step.views),
               "scan_ms": step.scan_ms, "refresh_ms": step.refresh_ms,
               "publish_ms": step.publish_ms, "nbytes": step.nbytes,
               "launches": {k: after[k] - before.get(k, 0) for k in after
                            if after[k] != before.get(k, 0)}}
        if step.plan is not None:
            rec["generation"] = step.plan.generation
            rec["solver_path"] = step.plan.stats.get("solver_path")
            rec["digest"] = _digest(
                store.get(plan_sync.plan_key(kv_prefix)).value)
        ticks.append(rec)
        return step
    tasks_mod.reaper_plan_step = recorded_step
    faulthandler.enable()
    done = threading.Event()

    def watch_plans():
        last = None
        while not done.wait(0.02):
            plan = strategies[0].plan if strategies else None
            if plan is not None and plan.generation != last:
                last = plan.generation
                plans.append((time.time(), last, _digest(plan.to_bytes())))
    threading.Thread(target=watch_plans, daemon=True,
                     name="cluster-plans").start()
    try:
        launcher.main(argv)
    finally:
        done.set()
    devices = [s.device for s in stores] + [s.device for s in strategies]
    cuda_dev = next((d for d in devices if d.type == "cuda"), None)
    emit({"pod": argv[argv.index("--instance-id") + 1], "pid": os.getpid(),
          "loader_devices": [str(s.device) for s in stores],
          "strategy_devices": [str(s.device) for s in strategies],
          "max_memory_allocated": (torch.cuda.max_memory_allocated(cuda_dev)
                                   if cuda_dev is not None else 0),
          "launches": all_launches(), "ticks": ticks, "plans": plans})
    return 0


class ClusterPod:
    """A launcher pod in a child process (``cluster_pod``): its stdout
    read on a thread (the READY line, then its JSON line), its stderr in a
    log file. ``channel``, ``iid`` and ``alive`` serve server_call and
    server_traffic."""

    def __init__(self, ops, kv_uri: str, iid: str, capacity_mb: int,
                 logdir: str, env: dict):
        self.ops, self.iid, self.alive = ops, iid, True
        self.endpoint, self.channel, self.lines = None, None, []
        self.log_path = os.path.join(logdir, f"{iid}.log")
        self.t0 = time.perf_counter()
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", CLUSTER_POD_CODE, "--kv", kv_uri,
                 "--instance-id", iid, "--runtime", "torch",
                 "--strategy", "torch", "--capacity-mb", str(capacity_mb),
                 "--load-timeout-s", "120", *CLUSTER_POD_ARGS],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=subprocess.PIPE, stderr=log, text=True, env=env)
        self._ready = threading.Event()
        self._reader = threading.Thread(target=self._read, daemon=True,
                                        name=f"pod-out-{iid}")
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            line = line.strip()
            if line.startswith("READY ") and self.endpoint is None:
                self.ready_s = time.perf_counter() - self.t0
                self.endpoint = line.split(" ", 1)[1]
                self._ready.set()
            elif line:
                self.lines.append(line)
        self._ready.set()

    def log_tail(self, n: int = 2000) -> str:
        with open(self.log_path) as f:
            return f.read()[-n:]

    def wait_ready(self, timeout: float) -> None:
        self._ready.wait(timeout)
        check(self.endpoint is not None,
              f"cluster: pod {self.iid} not ready (rc {self.proc.poll()}): "
              f"{self.log_tail()}")
        self.channel = self.ops.grpc.insecure_channel(self.endpoint)
        self.api = self.ops.grpc_defs.make_stub(
            self.channel, self.ops.grpc_defs.API_SERVICE,
            self.ops.grpc_defs.API_METHODS)

    def state(self) -> dict:
        """The pod's ***STATE*** dump over gRPC."""
        st = self.api.GetModelStatus(self.ops.apb.GetModelStatusRequest(
            model_id="***STATE***"), timeout=CLUSTER_WAIT_S)
        return json.loads(st.errors[0])

    def terminate(self, timeout: float = CLUSTER_WAIT_S) -> int:
        """SIGTERM (the launcher migrates its copies, then stops); the
        exit code."""
        import signal

        self.alive = False
        self.stopped_at = time.time()
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout)
        self._reader.join(10)
        if self.channel is not None:
            self.channel.close()
        if rc != 0:
            emit({"phase": "cluster_pod_exit", "pod": self.iid, "rc": rc,
                  "stderr_tail": self.log_tail(6000)})
        return rc

    def result(self) -> dict:
        rows = [json.loads(x) for x in self.lines if x.startswith("{")]
        check(rows, f"cluster: pod {self.iid} printed no result: "
              f"{self.log_tail()}")
        return rows[-1]

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)


def gpu_usage() -> dict:
    """The card's used memory (MiB) and its compute processes as
    nvidia-smi lists them (pid, used memory). In a container with its
    own PID namespace the list does not name the container's pids."""
    def query(*args):
        return subprocess.run(
            ["nvidia-smi", *args, "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.strip().splitlines()

    return {"memory_used_mib": float(query("--query-gpu=memory.used")[0]),
            "compute_apps": query("--query-compute-apps=pid,used_memory")}


def cluster_registry_matches(ops, kv, pods) -> list:
    """(model, holders in the registry read over ``kv``, holders by the
    live pods' caches) of every model where the two differ or a load is
    in flight."""
    from modelmesh_tpu_torch.kv.table import BucketedKVTable
    from modelmesh_tpu_torch.records import ModelRecord

    table = BucketedKVTable(kv, f"{CLUSTER_PREFIX}/registry", ModelRecord)
    live = [p for p in pods if p.alive]
    cached = {}
    for p in live:
        for e in p.state()["cache"]["entries"]:
            if e["state"] == ops.EntryState.ACTIVE.value:
                cached.setdefault(e["modelId"], set()).add(p.iid)
    bad = []
    for mid, mr in table.items():
        holders = set(mr.instance_ids)
        if holders != cached.get(mid, set()) or mr.loading_instances:
            bad.append((mid, sorted(holders),
                        sorted(cached.get(mid, set()))))
    return bad


def cluster_adoption(results: dict, stopped: dict) -> dict:
    """Each published reaper tick (any pod's) against every pod's plans:
    a pod still alive CLUSTER_ADOPT_S past the tick held a plan of at
    least its generation, and the tick's own generation with its digest.
    Returns the ticks, each with the pods it was checked on and their
    adoption delays (s)."""
    ticks = [dict(t, pod=pod) for pod, r in results.items()
             for t in r["ticks"] if t["published"]]
    ticks.sort(key=lambda t: t["t"])
    for t in ticks:
        t["adopted_by"] = {}
        for pod, r in results.items():
            if stopped[pod] < t["t"] + CLUSTER_ADOPT_S:
                continue
            later = [p for p in r["plans"] if p[1] >= t["generation"]]
            check(later, f"cluster: {pod} never adopted generation "
                  f"{t['generation']} (its plans {r['plans'][-3:]})")
            for _, gen, digest in later:
                check(gen != t["generation"] or digest == t["digest"],
                      f"cluster: {pod} holds generation {gen} with other "
                      f"bytes than {t['pod']} published")
            t["adopted_by"][pod] = later[0][0] - t["t"]
    return ticks


def cluster_scheme_pass(ops, scheme: str, capacity_mb: int, logdir, env,
                        payloads) -> dict:
    """Two pods on ``scheme``'s in-repo server (the port's etcd v3 wire
    server, or its ZooKeeper wire server), CLUSTER_SCHEME_MODELS models,
    CLUSTER_SCHEME_REQUESTS Predicts, then SIGTERM to both. Returns the
    pods' exit codes and results and the requests' rows."""
    from modelmesh_tpu_torch.kv.memory import InMemoryKV

    if scheme == "etcd":
        from modelmesh_tpu_torch.kv.etcd_server import start_etcd_server

        backing = InMemoryKV()
        server, port, _ = start_etcd_server(
            store=backing, max_workers=CLUSTER_KV_WORKERS)

        def stop():
            server.stop(0)
            backing.close()
    else:
        from modelmesh_tpu_torch.kv.zk_server import ZkWireServer

        zk = ZkWireServer().start()
        port, stop = zk.port, zk.stop
    pods = []
    try:
        pods = [ClusterPod(ops, f"{scheme}://127.0.0.1:{port}",
                           f"{scheme}-{k}", capacity_mb, logdir, env)
                for k in range(CLUSTER_SCHEME_PODS)]
        for p in pods:
            p.wait_ready(CLUSTER_START_S)
        models = [(f"{scheme}-m-{k}", MODEL_SPECS[k])
                  for k in range(CLUSTER_SCHEME_MODELS)]
        for k, (mid, (mtype, path)) in enumerate(models):
            pods[k % len(pods)].api.RegisterModel(
                ops.apb.RegisterModelRequest(
                    model_id=mid, info=ops.apb.ModelInfo(
                        model_type=mtype, model_path=path)),
                timeout=CLUSTER_WAIT_S)
        rows = [server_call(ops, pods[k % len(pods)],
                            models[k % len(models)][0],
                            payloads[models[k % len(models)][1][1]])
                for k in range(CLUSTER_SCHEME_REQUESTS)]
        rcs = {p.iid: p.terminate() for p in pods}
        results = {p.iid: p.result() for p in pods}
    finally:
        for p in pods:
            p.kill()
        stop()
    return {"models": dict(models), "rcs": rcs, "results": results,
            "rows": rows,
            "ready_s": {p.iid: p.ready_s for p in pods}}


def phase_cluster(dev, card: str) -> dict:
    """Launcher pods as separate processes on the card (module
    docstring, phase 16)."""
    import shutil
    import tempfile

    from modelmesh_tpu_torch.kv.service import RemoteKV, start_kv_server
    from modelmesh_tpu_torch.placement import plan_sync
    from modelmesh_tpu_torch.placement.torch_engine import GlobalPlan

    ops = server_ops()
    t0 = time.perf_counter()
    stages: dict = {}
    last = [t0]

    def stage(name: str) -> None:
        now = time.perf_counter()
        stages[name] = now - last[0]
        last[0] = now
        emit({"phase": "cluster_stage", "stage": name, "s": stages[name]})

    models = [(f"c-{k}-{j}", spec) for k, spec in enumerate(MODEL_SPECS)
              for j in range(CLUSTER_PER_SPEC)]
    specs_by_id = dict(models)
    specs_by_id.update({m["modelId"]: (m["type"], m["path"])
                        for m in SERVER_STATIC["models"]})
    payloads, built = {}, 0
    for k, (mtype, path) in enumerate(MODEL_SPECS):
        model = ops.tf.build_model("payload", mtype, path, device=dev)
        payloads[path] = model_input(model, 1, CLUSTER_SEED + k).tobytes()
        built += model.size_bytes * (CLUSTER_PER_SPEC + 2)
    # Every pod could hold the whole registry: the phase measures the
    # processes and the wire, not eviction.
    capacity_mb = -(-built // (1 << 20)) + 64
    result = {"phase": "cluster", "card": card, "pods": CLUSTER_PODS,
              "models": len(models) + len(SERVER_STATIC["models"]),
              "clients": SERVER_CLIENTS, "zipf": SERVER_ZIPF,
              "pod_capacity_mb": capacity_mb, "tasks": CLUSTER_TASKS}
    ref = ops.TorchModelStore(1 << 36, device=dev)
    env = dict(os.environ, MM_LOG_LEVEL="WARNING")
    logdir = tempfile.mkdtemp(prefix="mm-cluster-")
    backing = ops.InMemoryKV()
    kv_server, kv_port, _ = start_kv_server(
        store=backing, max_workers=CLUSTER_KV_WORKERS)
    kv = RemoteKV(f"127.0.0.1:{kv_port}")
    pods: list = []
    rows: list = []
    usage_before = gpu_usage()
    try:
        pods = [ClusterPod(
            ops, f"mesh://127.0.0.1:{kv_port}", f"pod-{k}", capacity_mb,
            logdir, dict(env, MM_STATIC_MODELS=json.dumps(SERVER_STATIC))
            if k == 0 else env) for k in range(CLUSTER_PODS)]
        for p in pods:
            p.wait_ready(CLUSTER_START_S)
        result["start_s"] = {p.iid: p.ready_s for p in pods}
        wait_until(lambda: all(len(p.state()["cluster"]) == CLUSTER_PODS
                               for p in pods),
                   "every pod seeing the others", CLUSTER_WAIT_S)
        stage("start")
        for k, (mid, (mtype, path)) in enumerate(models):
            st = pods[k % len(pods)].api.RegisterModel(
                ops.apb.RegisterModelRequest(
                    model_id=mid, info=ops.apb.ModelInfo(
                        model_type=mtype, model_path=path)),
                timeout=CLUSTER_WAIT_S)
            check(st.model_id == mid, f"cluster: RegisterModel {mid}: {st}")
        n_models = result["models"]
        wait_until(lambda: all(len(p.state()["registry"]) >= n_models
                               for p in pods),
                   "every pod's view of the registry", CLUSTER_WAIT_S)
        stage("register")
        rows += server_traffic(ops, pods, models, payloads,
                               CLUSTER_REQUESTS, CLUSTER_SEED + 1)
        stage("traffic")
        # The pods on the card, while they hold their copies: the card's
        # used memory rose by their share (each pod's own report of its
        # device and peak memory is held at the end).
        usage = gpu_usage()
        result["gpu_usage"] = {"before": usage_before, "pods_up": usage,
                               "pids": {p.iid: p.proc.pid for p in pods}}
        rise = usage["memory_used_mib"] - usage_before["memory_used_mib"]
        check(rise >= CLUSTER_POD_MIN_MIB * CLUSTER_PODS,
              f"cluster: the card's used memory rose {rise} MiB with "
              f"{CLUSTER_PODS} pods up ({usage_before} -> {usage})")
        # At least two reaper ticks published, read from the KV.
        def plan_generation():
            kvp = kv.get(plan_sync.plan_key(CLUSTER_PREFIX))
            return (GlobalPlan.from_bytes(kvp.value).generation
                    if kvp is not None else 0)

        gen0 = plan_generation()
        wait_until(lambda: plan_generation() >= gen0 + 2,
                   "two reaper ticks publishing a plan", CLUSTER_WAIT_S)
        # Every pod stays up long enough to be held to their adoption
        # (the ticks' stamps come a KV read after their publish).
        time.sleep(CLUSTER_ADOPT_S + 0.5)
        stage("ticks")
        # A non-leader drains on SIGTERM while clients keep sending to the
        # survivors; then each of its models once at a survivor.
        leaders = [p for p in pods if p.state()["isLeader"]]
        check(len(leaders) == 1, f"cluster: leaders {leaders}")
        drained = next(p for p in reversed(pods) if p is not leaders[0])
        held = [e["modelId"] for e in drained.state()["cache"]["entries"]
                if e["state"] == ops.EntryState.ACTIVE.value]
        survivors = [p for p in pods if p is not drained]
        during: list = []
        sender = threading.Thread(target=lambda: during.extend(
            server_traffic(ops, survivors, models, payloads,
                           CLUSTER_DRAIN_REQUESTS, CLUSTER_SEED + 2)),
            name="cluster-drain-traffic")
        t = time.perf_counter()
        sender.start()
        drain_rc = drained.terminate()
        drain_s = time.perf_counter() - t
        sender.join()
        check(drain_rc == 0, f"cluster: the drained pod exited {drain_rc}: "
              f"{drained.log_tail()}")
        moved = [server_call(ops, survivors[k % len(survivors)], mid,
                             payloads[specs_by_id[mid][1]])
                 for k, mid in enumerate(held)]
        for r in moved:
            check(r["error"] is None and r["served_by"] != drained.iid,
                  f"cluster: {r['model']} after the drain: {r}")
        rows += during + moved
        result["drain"] = {"pod": drained.iid, "leader": leaders[0].iid,
                           "s": drain_s, "held": held,
                           "requests_during": len(during)}
        stage("drain")
        try:
            wait_until(lambda: not cluster_registry_matches(ops, kv, pods),
                       "the registry settling", CLUSTER_WAIT_S)
        except RuntimeError:
            check(False, f"cluster: registry and caches disagree: "
                  f"{cluster_registry_matches(ops, kv, pods)[:5]}")
        stage("quiesce")
        rcs = {p.iid: p.terminate() for p in survivors}
        rcs[drained.iid] = drain_rc
        check(all(rc == 0 for rc in rcs.values()),
              f"cluster: pods exited {rcs}")
        results = {p.iid: p.result() for p in pods}
        stopped = {p.iid: p.stopped_at for p in pods}
        stage("stop")
    finally:
        for p in pods:
            p.kill()
        kv.close()
        kv_server.stop(0)
        backing.close()
    worst = check_answers(ref, rows, specs_by_id, payloads, "cluster")
    for pod, r in results.items():
        check(r["loader_devices"] and all(
            d.startswith("cuda") for d in r["loader_devices"]
            + r["strategy_devices"]) and r["max_memory_allocated"] > 0,
            f"cluster: {pod} ran on {r['loader_devices']} / "
            f"{r['strategy_devices']}, peak {r['max_memory_allocated']} B")
    published = cluster_adoption(results, stopped)
    everywhere = [t for t in published
                  if len(t["adopted_by"]) == CLUSTER_PODS]
    check(len(everywhere) >= 2,
          f"cluster: {len(everywhere)} published reaper ticks adopted by "
          f"all {CLUSTER_PODS} pods ({len(published)} published)")
    delays = [d for t in published for d in t["adopted_by"].values()]
    for t in published:
        for name in ("lse_sinkhorn_step", "row_lse_partial", "implied_load"):
            check(t["launches"].get(name, 0) > 0,
                  f"cluster: a tick of {t['pod']} never launched {name} "
                  f"({t['launches']})")
    stage("answers")
    # The other protocols' passes side by side, each on its own thread.
    passes: dict = {}
    threads = [threading.Thread(
        target=lambda s=s: passes.__setitem__(s, cluster_scheme_pass(
            ops, s, capacity_mb, logdir, env, payloads)),
        name=f"cluster-{s}") for s in CLUSTER_SCHEMES]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    check(sorted(passes) == sorted(CLUSTER_SCHEMES),
          f"cluster: the passes {sorted(passes)} of {CLUSTER_SCHEMES} ended")
    shutil.rmtree(logdir, ignore_errors=True)   # kept when a pod failed
    schemes = {}
    for s, r in passes.items():
        check(all(rc == 0 for rc in r["rcs"].values()),
              f"cluster: {s} pods exited {r['rcs']}")
        for pod, res in r["results"].items():
            check(res["loader_devices"] and all(
                d.startswith("cuda") for d in res["loader_devices"])
                and res["max_memory_allocated"] > 0,
                f"cluster: {pod} ran on {res['loader_devices']}, peak "
                f"{res['max_memory_allocated']} B")
        specs_by_id.update(r["models"])
        schemes[s] = {
            "start_s": r["ready_s"], "exit_codes": r["rcs"],
            "requests": len(r["rows"]),
            "max_err_by_spec": check_answers(
                ref, r["rows"], specs_by_id, payloads, f"cluster {s}"),
            "served_by": {pod: sum(x["served_by"] == pod for x in r["rows"])
                          for pod in r["rcs"]}}
    stage("schemes")
    launches: dict = {}
    for r in list(results.values()) + [
            x for s in passes.values() for x in s["results"].values()]:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    ms = [r["ms"] for r in rows]
    result.update({
        "requests": len(rows),
        "latency_ms": {"median": float(np.median(ms)),
                       "p99": float(np.percentile(ms, 99)),
                       "max": float(np.max(ms))},
        "served_by": {p.iid: sum(r["served_by"] == p.iid for r in rows)
                      for p in pods},
        "max_err_by_spec": worst,
        "exit_codes": rcs,
        "max_memory_allocated": {p: r["max_memory_allocated"]
                                 for p, r in results.items()},
        "published_ticks": len(published),
        "ticks_adopted_everywhere": len(everywhere),
        "ticks": [{k: t[k] for k in ("pod", "generation", "records",
                                     "views", "refresh_ms", "scan_ms",
                                     "publish_ms", "nbytes", "launches",
                                     "solver_path", "adopted_by")}
                  for t in published[:4]],
        "adopt_delay_ms": {"max": max(delays) * 1e3,
                           "median": float(np.median(delays)) * 1e3},
        "schemes": schemes,
        "launches_in_run": {k: v for k, v in launches.items() if v},
        "stages_s": stages, "seconds": time.perf_counter() - t0,
    })
    emit(result)
    check(result["seconds"] < CLUSTER_BUDGET_S,
          f"cluster took {result['seconds']:.1f} s, over "
          f"{CLUSTER_BUDGET_S} s")
    return result


# The simulator (modelmesh_tpu_torch/sim/), on the card's host: it takes
# no device and launches no kernel; its pods are full port instances in
# front of SimLoader under a VirtualClock.
SIM_BUDGET_S = 120.0
SIM_REPLAYED = "rolling_restart_under_zipf_load"
SIM_SWEEP = ("--seed", "0", "--sweeps", "8", "--steps", "40")
# The macro headline's widths (bench_macro.py run_headline) at its seed;
# its virtual day cut to 20 minutes (1,800 virtual s took 56.9-65.0 s of
# the card host's wall time, over the 60 s this part may take).
SIM_MACRO = {"pods": 1_000, "users": 1_000_000, "models": 2_048,
             "day_s": 1_200, "seed": 1_700}
SIM_MACRO_DAY_S = 86_400
SIM_SCENARIOS_CHILD = """
import json, sys, time
from modelmesh_tpu_torch.ops import cuda_load, cuda_lse, cuda_random, cuda_sparse
from modelmesh_tpu_torch.sim import scenarios
from modelmesh_tpu_torch.sim.scenario import run_scenario
mods = (cuda_load, cuda_lse, cuda_random, cuda_sparse)
for m in mods:
    m.reset_launches()
t0 = time.perf_counter()
results = scenarios.run_all()
all_s = time.perf_counter() - t0
t0 = time.perf_counter()
runs = [run_scenario(getattr(scenarios, sys.argv[1])()) for _ in range(2)]
replay_s = time.perf_counter() - t0
launches = {}
for m in mods:
    launches.update(m.launches)
import torch
print(json.dumps({
    "scenarios": [{"name": r.name, "ok": r.ok, "wall_s": r.wall_s,
                   "failed": sorted(k for k, v in r.verdicts.items() if v)}
                  for r in results],
    "run_all_s": all_s,
    "replay": {"ok": [r.ok for r in runs], "wall_s": [r.wall_s for r in runs],
               "equal": runs[0].trace_lines() == runs[1].trace_lines(),
               "trace_lines": len(runs[0].trace_lines()), "seconds": replay_s},
    "launches": launches, "cuda_initialized": torch.cuda.is_initialized(),
}))
"""


def sim_sweep_verdicts(out: str) -> dict:
    """The explorer's output, seed by seed: its verdict, the run's wall
    s, the invariants that failed and whether it printed the replay
    line."""
    seeds: dict = {}
    current = None
    for line in out.splitlines():
        if line.startswith(("[PASS] seed=", "[FAIL] seed=")):
            current = int(line.split("seed=")[1].split()[0])
            seeds[current] = {"ok": line.startswith("[PASS]"), "failed": [],
                              "replay": False,
                              "wall_s": float(line.split("wall=")[1][:-1])}
        elif current is not None and line.startswith("invariant ") and (
                ": FAIL" in line):
            seeds[current]["failed"].append(
                line[len("invariant "):].split(":")[0])
        elif current is not None and line.startswith("REPLAY: "):
            seeds[current]["replay"] = True
    return seeds


def phase_sim(card: str) -> dict:
    """The port's simulator on the card's host (module docstring, phase
    17), in child processes through its entry points: every scripted
    scenario through run_all() and one of them twice, the seeded
    explorer's command line, and the macro fleet's at the headline's
    widths, that one beside the others."""
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    macro_args = [sys.executable, "-m", "modelmesh_tpu_torch.sim", "--macro",
                  "--authority", "burn", "--admission"] + [
        f"--{k.replace('_', '-')}={v}" for k, v in SIM_MACRO.items()]
    macro = subprocess.Popen(macro_args, cwd=root, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    macro_io: dict = {}

    def collect():
        macro_io["out"], macro_io["err"] = macro.communicate()
        macro_io["seconds"] = time.perf_counter() - t0

    collector = threading.Thread(target=collect, name="sim-macro")
    collector.start()
    try:
        t = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", SIM_SCENARIOS_CHILD, SIM_REPLAYED],
            cwd=root, env=env, capture_output=True, text=True, timeout=300)
        scen_s = time.perf_counter() - t
        check(child.returncode == 0,
              f"sim: the scenarios' child exited {child.returncode}: "
              f"{child.stderr[-2000:]}")
        got = json.loads(child.stdout.strip().splitlines()[-1])
        t = time.perf_counter()
        sweep = subprocess.run(
            [sys.executable, "-m", "modelmesh_tpu_torch.sim", *SIM_SWEEP],
            cwd=root, env=env, capture_output=True, text=True, timeout=300)
        sweep_s = time.perf_counter() - t
        collector.join(timeout=300)
    finally:
        if macro.poll() is None:
            macro.kill()
        collector.join()
    macro_out, macro_err = macro_io["out"], macro_io["err"]
    macro_s = macro_io["seconds"]
    seeds = sim_sweep_verdicts(sweep.stdout)
    summary = json.loads(macro_out.strip().splitlines()[-1]) if (
        macro.returncode == 0 and macro_out.strip()) else {}
    result = {
        "phase": "sim", "card": card,
        "scenarios": {s["name"]: {"ok": s["ok"], "wall_s": s["wall_s"],
                                  "failed": s["failed"]}
                      for s in got["scenarios"]},
        "scenarios_child_s": scen_s, "run_all_s": got["run_all_s"],
        "replay": dict(got["replay"], scenario=SIM_REPLAYED),
        "sweep": {"args": list(SIM_SWEEP), "exit_code": sweep.returncode,
                  "seconds": sweep_s,
                  "failed_seeds": {s: v["failed"] for s, v in seeds.items()
                                   if not v["ok"]},
                  "passed_seeds": sorted(s for s, v in seeds.items()
                                         if v["ok"]),
                  "run_wall_s": {s: v["wall_s"] for s, v in seeds.items()}},
        "macro": {"args": macro_args[3:], "exit_code": macro.returncode,
                  "seconds": macro_s,
                  "cut": f"depth: a virtual {SIM_MACRO['day_s']} s of the "
                         f"headline's {SIM_MACRO_DAY_S} s day; widths as "
                         f"the headline's (pods, users, models, seed); the "
                         f"command line's mix (classes hi 0.2 / default "
                         f"0.8, no flash crowd or churn)",
                  **{k: summary.get(k) for k in (
                      "digest", "engine_events", "requests_simulated",
                      "offered", "served", "shed", "failed", "p50_ms",
                      "p99_ms", "classes", "fleet",
                      "conservation_violations")}},
        "launches_in_run": got["launches"],
        "cuda_initialized_in_child": got["cuda_initialized"],
        "seconds": time.perf_counter() - t0,
    }
    emit(result)
    bad = [n for n, s in result["scenarios"].items() if not s["ok"]]
    check(len(result["scenarios"]) == 15 and not bad,
          f"sim: scenarios failed: {bad}")
    check(all(got["replay"]["ok"]) and got["replay"]["equal"],
          f"sim: {SIM_REPLAYED} twice: {got['replay']}")
    check(sorted(seeds) == list(range(8))
          and sweep.returncode in (0, 1)
          and (sweep.returncode == 1) == any(not v["ok"]
                                             for v in seeds.values()),
          f"sim: the explorer exited {sweep.returncode} with "
          f"{seeds}: {sweep.stderr[-2000:]}")
    # A seed that fails is a finding of the explorer, as in the
    # reference at these settings (ROADMAP.md queue 3): it must name the
    # invariants it broke and print its replay line.
    for s, v in seeds.items():
        check(v["ok"] or (v["replay"] and v["failed"]),
              f"sim: explorer seed {s} failed {v['failed']} (replay line "
              f"printed: {v['replay']})")
    check(macro.returncode == 0 and summary,
          f"sim: the macro exited {macro.returncode}: {macro_err[-2000:]}")
    check(summary["conservation_violations"] == []
          and summary["offered"] == summary["served"] + summary["shed"]
          + summary["failed"]
          and summary["requests_simulated"] >= SIM_MACRO["users"],
          f"sim: the macro's accounts: {result['macro']}")
    check(not any(got["launches"].values())
          and not got["cuda_initialized"],
          f"sim: the scenarios touched the card: {got['launches']}")
    check(result["seconds"] < SIM_BUDGET_S,
          f"sim took {result['seconds']:.1f} s, over {SIM_BUDGET_S} s")
    return result


# The import-order check: a process that reached cuBLAS before importing
# the port must be refused a CUDA model store, and one that set the
# variable first must keep batch parity.
IMPORT_ORDER_LATE = """
import torch
a = torch.randn(256, 256, device="cuda")
(a @ a).sum().item()
import modelmesh_tpu_torch
from modelmesh_tpu_torch.models.server import TorchModelStore
try:
    TorchModelStore(1 << 20, device="cuda")
except RuntimeError as e:
    print("REFUSED", e)
else:
    print("ACCEPTED")
"""
IMPORT_ORDER_EARLY = """
import sys
import torch
a = torch.randn(256, 256, device="cuda")
(a @ a).sum().item()
sys.path.insert(0, "tools")
import batch_parity
sys.exit(batch_parity.main(["batch_parity", "--payloads", "8"]))
"""
BATCH_PARITY_TOL = 1.2e-6


def phase_import_order(card: str) -> dict:
    """The cuBLAS import-order rule on the card, in two fresh processes
    (module docstring, phase 18)."""
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k != "CUBLAS_WORKSPACE_CONFIG"}
    late = subprocess.run([sys.executable, "-c", IMPORT_ORDER_LATE],
                          cwd=root, env=env, capture_output=True,
                          text=True, timeout=300)
    check(late.returncode == 0 and "REFUSED" in late.stdout
          and "CUBLAS_WORKSPACE_CONFIG" in late.stdout,
          f"import_order: a late import was not refused: {late.stdout} "
          f"{late.stderr[-2000:]}")
    early = subprocess.run(
        [sys.executable, "-c", IMPORT_ORDER_EARLY], cwd=root,
        env=dict(env, CUBLAS_WORKSPACE_CONFIG=":0:0"),
        capture_output=True, text=True, timeout=600)
    check(early.returncode == 0,
          f"import_order: batch parity failed: {early.stderr[-2000:]}")
    parity = json.loads(early.stdout.strip().splitlines()[-1])
    worst = 0.0
    for path, res in parity["specs"].items():
        for kind in ("pad", "mix", "fused"):
            for v in res[kind].values():
                worst = max(worst, v["max"])
    result = {"phase": "import_order", "card": card,
              "late": late.stdout.strip(),
              "early_workspace": parity["cublas_workspace_config"],
              "early_worst_rel_err": worst,
              "specs": sorted(parity["specs"]),
              "seconds": time.perf_counter() - t0}
    emit(result)
    check(worst <= BATCH_PARITY_TOL,
          f"import_order: batched/fused answers {worst:.3g} of max|ref| "
          f"from solo, over {BATCH_PARITY_TOL}")
    return result


def kernel_entries(table: dict, lib: str, launches: dict,
                   cells: dict) -> list:
    """The contract's kernel objects; ``launches`` by kernel, each from
    the run of the cell that runs it, ``cells`` by kernel: (cell, solves
    in that run)."""
    return [
        {
            "name": name, "route": "cuda", "source": SOURCES[lib],
            "replaces": REPLACES[name], "launches": launches[name],
            "cell": cells[name][0], "solves": cells[name][1],
            "launches_per_solve": launches[name] / cells[name][1],
            "shape": k["shape"],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        }
        for name, k in table.items()
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    phase_build()
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card})
    kernels = phase_kernels(dev, card)
    lse_kernels = phase_lse_kernels(dev, card)
    load_kernel = phase_load_kernel(dev, card)
    t0 = time.perf_counter()
    cols = steady_fleet(*MAIN_FLEET)
    main_run = phase_main(dev, cols, time.perf_counter() - t0)
    phase_profile(dev, cols)
    phase_parity(dev)
    wide_launches = phase_wide(dev)
    with dense_pin():
        dense_run = phase_dense_main(dev, cols)
        phase_profile(dev, cols, "dense_profile")
    phase_parity(dev, DENSE_PARITY_FLEET, "dense_parity", "dense")
    dense_wide_launches = phase_dense_wide(dev)
    steady = phase_steady(dev, card)
    pipelined = phase_pipelined(dev, card)
    threefry = phase_threefry(dev, card, cols)
    sharded = phase_sharded(dev, card, cols)
    phase_models(dev, card)
    phase_runtime_mesh(dev, card)
    plan_loop = phase_plan_loop(dev, card)
    instance = phase_instance(dev, card)
    server = phase_server(dev, card)
    cluster = phase_cluster(dev, card)
    sim = phase_sim(card)
    phase_import_order(card)
    print(card)
    # The column-only kernels run on the wide paths alone (one solve each;
    # the main paths' 1024 columns take the fused steps).
    sparse_launches = dict(main_run["launches"],
                           masked_col_matvec=wide_launches["masked_col_matvec"])
    sparse_cells = dict.fromkeys(sparse_launches, ("main", MAIN_SOLVES))
    sparse_cells["masked_col_matvec"] = ("wide", 1)
    lse_launches = dict(dense_run["launches"],
                        col_lse_partial=dense_wide_launches["col_lse_partial"])
    lse_cells = dict.fromkeys(lse_launches, ("dense_main", MAIN_SOLVES))
    lse_cells["col_lse_partial"] = ("dense_wide", 1)
    # The implied load runs in both auctions: its launches are the sparse
    # main path's, the dense main path's beside them.
    load_entries = kernel_entries(load_kernel, "implied_load",
                                  main_run["launches"],
                                  {"implied_load": ("main", MAIN_SOLVES)})
    load_entries[0]["dense_main_launches"] = (
        dense_run["launches"]["implied_load"])
    # The steady cell's incremental refreshes run kernel 4 (the dirty
    # rows' row potential) and the implied load once each.
    per_refresh = steady["incremental"]["launches_per_incremental_refresh"]
    lse_entries = kernel_entries(lse_kernels, "lse", lse_launches, lse_cells)
    steady_lse = steady["row_lse_at_steady_shape"]
    for entry in lse_entries:
        if entry["name"] == "row_lse_partial":
            entry.update({
                "steady_launches_per_refresh": per_refresh["row_lse_partial"],
                "steady_shape": steady_lse["shape"],
                "steady_ms": steady_lse["ms"],
                "steady_plain_ms": steady_lse["plain_ms"],
                "steady_bound_ms": steady_lse["bound_ms"],
                "steady_bound_by": steady_lse["bound_by"],
                "steady_library_ms": steady_lse["library_ms"],
                "steady_max_abs_err": steady_lse["max_abs_err"],
                "steady_kernel_split_ms": steady_lse["kernel_split_ms"],
            })
    load_entries[0]["steady_launches_per_refresh"] = (
        per_refresh["implied_load"])
    threefry_entries = kernel_entries(
        {"threefry_gumbel": threefry["threefry_gumbel"]}, "threefry",
        threefry["launches"], {"threefry_gumbel": ("threefry", 1)})
    entries = (kernel_entries(kernels, "masked_sparse", sparse_launches,
                              sparse_cells)
               + lse_entries + load_entries + threefry_entries)
    # The pipelined refresher's run (priming submit, cycles, drain) drives
    # the sparse kernels on its full cycles and kernel 4 and the implied
    # load on its incremental ones.
    for entry in entries:
        entry["pipelined_launches"] = pipelined["launches_in_run"].get(
            entry["name"], 0)
        entry["sharded_launches"] = sharded["launches_in_run"].get(
            entry["name"], 0)
        entry["plan_loop_launches"] = plan_loop["launches_in_run"].get(
            entry["name"], 0)
        entry["instance_launches"] = instance["launches_in_run"].get(
            entry["name"], 0)
        entry["server_launches"] = server["launches_in_run"].get(
            entry["name"], 0)
        entry["cluster_launches"] = cluster["launches_in_run"].get(
            entry["name"], 0)
        entry["sim_launches"] = sim["launches_in_run"].get(
            entry["name"], 0)
    emit({"kernels": entries})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
